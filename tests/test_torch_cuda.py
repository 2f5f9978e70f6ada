"""The port's CUDA kernel on the card (marker `gpu`; skips without one).

Run on a machine with an NVIDIA GPU and nvcc, from the repository root:

    python -m pytest --noconftest -o addopts="" -m gpu tests/test_torch_cuda.py

(`--noconftest`: tests/conftest.py imports jax, which that machine need not
have; this file imports only torch and the port.) Each kernel is held
against its plain PyTorch version on the same CUDA tensors: scaler counts
equal, root CLVs to 1e-5 of each site's largest entry (FMA contraction vs
PyTorch's summation order). In the rows kernel's 'bf16' and 'split' modes
(the tensor cores, `test_rows_kernel_rounded_modes_match_plain_on_card`)
both versions round the same operands to bf16, but a last-bit difference
of a float32 sum can round a value to the other bf16 neighbour, and the
tensor cores' float32 accumulation rounds toward zero: counts equal but
at ties (at most 8 entries, by one), 'split''s root CLVs to 5e-4 of each
site's largest entry (measured 1.0e-4), 'bf16''s to 2^-4 (measured
1.2e-2) and both at the logL level, to 1e-4 relative. The level kernel (csrc/level_update.cu)
is held to equal scaler rows and CLV rows to 1e-5 of each site's largest
entry over a whole traversal, level by level; the pool kernel
(csrc/pool_update.cu: the 4x4 size one launch a traversal, on device
counters, or one level a launch when called a level at a time; other
sizes one launch a level) to equal scaler regions (the trash region aside,
which ops without a scaler buffer write at once) and class columns to
1e-5 of each column's largest entry. Their per-rate and raw-tip
modes are held the same way, counts compared per rate; the matrix-unit
probe (csrc/mxu_probe.cu: CUDA-core FMAs, wgmma) to 1e-5 of its output's
largest entry in 'f32' (the two versions add the same products in another
order) and 5e-5 in 'bf16' and 'split' (the tensor cores' float32
accumulation rounds toward zero), zero at no iteration."""
import copy

import numpy as np
import pytest
import torch

from libpll2_tpu_torch import Partition, TreeEngine, compute_gamma_cats
from libpll2_tpu_torch.engine import _fused_loglikelihood
from libpll2_tpu_torch.io import maps
from libpll2_tpu_torch.models import load_aa_model
from libpll2_tpu_torch.ops import _kernels, fused, levels, pool
from libpll2_tpu_torch.ops.pmatrix import update_prob_matrices
from libpll2_tpu_torch.trees import (create_operations, parse_newick,
                                     random_alignment, random_utree,
                                     traverse)
from libpll2_tpu_torch.utils import simulate_alignment
from torch_level_ops import self_child_op

pytestmark = pytest.mark.gpu

CHARMAP5 = np.zeros(256, np.uint64)
for _i, _ch in enumerate("ACGTX"):
    CHARMAP5[ord(_ch)] = 1 << _i
CHARMAP5[ord("-")] = 31
LETTERS32 = "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdef"
LETTERS64 = LETTERS32 + "ghijklmnopqrstuvwxyz0123456789@#"
AA_NOISY = "ARNDCQEGHILKMFPSTWYVARNDCQEGHILKMFPSTWYVBZX-"


def _charmap(states):
    """States 0..s-1 as the first s of LETTERS64; '-' is every state."""
    cm = np.zeros(256, np.uint64)
    for i, ch in enumerate(LETTERS64[:states]):
        cm[ord(ch)] = 1 << i
    cm[ord("-")] = (1 << states) - 1
    return cm


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _engine(tree, sites, device, dtype=torch.float32, rates=4, states=4,
            alphabet="ACGT-NRY", seed=3, rate_scalers=False):
    headers, seqs = random_alignment(tree.tip_count, sites,
                                     alphabet=alphabet, seed=seed)
    by = dict(zip(headers, seqs))
    part = Partition(tree.tip_count, tree.inner_count, states, sites, 1,
                     tree.edge_count, rates, tree.inner_count, device=device,
                     dtype=dtype, rate_scalers=rate_scalers)
    charmap = {4: maps.map_nt, 5: CHARMAP5, 20: maps.map_aa}.get(
        states, None)
    if charmap is None:
        charmap = _charmap(states)
    for tip in tree.tips():
        part.set_tip_states(tip.clv_index, charmap, by[tip.label])
    rng = np.random.default_rng(seed)
    if states == 20:
        load_aa_model(part, "lg")
    else:
        part.set_frequencies(0, rng.dirichlet(np.ones(states) * 10))
        part.set_subst_params(0, rng.uniform(0.5, 2.0,
                                             size=states * (states - 1) // 2))
    part.set_category_rates(compute_gamma_cats(0.8, rates))
    return part, TreeEngine(part, tree)


def _inputs(part, eng):
    m = eng._model_args()
    pm = update_prob_matrices(m[0], m[1], m[2], m[3], m[4], m[7],
                              eng.branches)
    kw = dict(rates=part.rate_cats, states=part.states,
              n_slots=eng.fused_slots, threshold=part.scale_threshold,
              factor=part.scale_factor, splits=eng.fused_splits)
    return (eng._tip_codes(), pm, eng.table), kw


def _caterpillar(n):
    text = f"t{n - 1}:0.1"
    for i in range(n - 2, 1, -1):
        text = f"(t{i}:0.1,{text}):0.1"
    return parse_newick(f"(t0:0.1,t1:0.1,{text});")


# fused_traversal.cu's plan (ops/_kernels.py:fused_plan) for each case on an
# H100 (132 SMs): 'wide' (40003 sites, a tail of 3) two sites a thread (2
# threads a site), 'narrow' (4159 sites, the widest alignment with one site
# a thread, a tail of 31) and 1000 or 700 sites one (4 threads a site);
# 'spill' (250 slots) does not fit on chip, and other sizes than 4 states x
# 4 rates run the runtime-size body on chip, a site's 3 or 4 rates on 4
# lanes (generic_plan)
FUSED_PLANS = {"ragged": ("on-chip", 4), "caterpillar": ("on-chip", 4),
               "wide": ("on-chip", 2), "narrow": ("on-chip", 4),
               "spill": ("spill", 1), "rates3": ("on-chip", 4),
               "states5": ("on-chip", 4)}
FUSED_SPILL_SLOTS = 250
# slots that do not fit one warp's block of the runtime-size body in float32
# at 4 or more states (640 bytes a slot at 4 states): its spill plan
GENERIC_SPILL_SLOTS = 1000


def _assert_fused_plan(part, n_slots, want, splits=None, raw_tips=False):
    """The plan the launcher takes for an engine's walk (with `splits`, its
    table's ops/fused.py:FusedSplits, the thread block cluster on the 4 x 4
    on-chip body): (plan, threads a site) and, where `want` names it,
    blocks a cluster, which is 1 otherwise."""
    from libpll2_tpu_torch.ops import _kernels

    plan = _kernels.device_fused_plan(part.device, part.rate_cats,
                                      part.states, n_slots,
                                      part.rate_scalers, part.sites_padded,
                                      1, raw_tips, splits)
    want = tuple(want) + (1,) * (3 - len(want))
    assert (plan.plan, plan.threads_per_site,
            getattr(plan, "cluster", 1)) == want
    return plan


CLUSTER_SIZES = (1, 2, 4, 8)


def _assert_clusters_equal(args, kw):
    """A 4 x 4 on-chip launch (one walk, K candidates or Q x K queries) at
    every cluster size, forced through the launcher's plan argument, equals
    the one at G = 1 bit for bit; other plans are not clustered. Returns
    the sizes compared."""
    codes, pm, table = args
    if (kw["rates"], kw["states"]) != (4, 4):
        return ()
    one = table.dim() == 2
    t, p = (table[None], pm[None]) if one else (table, pm)
    q = kw["query_codes"].shape[0] if kw.get("query_codes") is not None \
        else 1
    base = _kernels.device_fused_plan(
        pm.device, 4, 4, kw["n_slots"], kw.get("rate_scalers", False),
        codes.shape[1], q * t.shape[0], kw.get("tip_clvs") is not None)
    if base.plan != "on-chip":
        return ()
    splits = fused.FusedSplits(t.cpu().numpy())

    def launch(g):
        return _kernels.launch_fused_traversal(
            codes, p, t, 4, 4, kw["n_slots"], kw["threshold"], kw["factor"],
            kw.get("rate_scalers", False), kw.get("tip_clvs"),
            kw.get("query_codes"), kw.get("query_row", -1),
            plan=base._replace(cluster=g), splits=splits)

    ref = launch(1)
    for g in CLUSTER_SIZES[1:]:
        got = launch(g)
        torch.cuda.synchronize()
        for a, b in zip(got, ref):
            assert a.shape == b.shape and torch.equal(a, b), g
    return CLUSTER_SIZES


@pytest.mark.parametrize("case", ["ragged", "rates3", "states5",
                                  "caterpillar", "wide", "narrow", "spill"])
def test_kernel_matches_plain_on_card(cuda, case):
    tree = random_utree([f"t{i}" for i in range(16)], seed=3)
    if case == "caterpillar":
        part, eng = _engine(_caterpillar(80), 700, cuda, alphabet="ACGT")
    elif case in ("wide", "narrow"):
        part, eng = _engine(tree, 40003 if case == "wide" else 4159, cuda)
    else:
        kw = {"rates3": dict(rates=3),
              "states5": dict(states=5, alphabet="ACGTX-")}.get(case, {})
        part, eng = _engine(tree, 1000, cuda, **kw)
    args, kw = _inputs(part, eng)
    if case == "spill":
        kw["n_slots"] = FUSED_SPILL_SLOTS
    _assert_fused_plan(part, kw["n_slots"], FUSED_PLANS[case],
                       eng.fused_splits)
    before = fused.fused_traversal.launches
    got = fused.fused_traversal(*args, **kw)
    assert fused.fused_traversal.launches == before + 1
    assert bool(_assert_clusters_equal(args, kw)) == (
        FUSED_PLANS[case][0] == "on-chip" and case not in ("rates3",
                                                            "states5"))
    want = fused.fused_traversal_reference(*args, **kw)
    torch.cuda.synchronize()
    for g, w in zip(got[2:], want[2:]):
        assert torch.equal(g, w)
    for g, w in zip(got[:2], want[:2]):
        site_max = w.abs().amax(dim=(0, 1)).clamp(min=1e-30)
        assert float(((g - w).abs() / site_max).max()) <= 1e-5
    if case == "caterpillar":
        assert int(want[2].max()) > 0


# launches whose plan takes a thread block cluster on an H100 (132 SMs;
# ops/_kernels.py:fused_plan from ops/fused.py:split_fused_schedule): name
# -> (taxa, tree seed, sites, per-rate counts, raw tips on every other tip,
# blocks a cluster). The DNA main path's 128 x 16384 walk (126 ops) takes
# 2, the 246 x 4465 repeats shape (244 ops) 4, a 128 x 4096 shard 4
CLUSTER_CASES = {"dna_main": (128, 7, 16384, False, False, 2),
                 "dna_main_per_rate": (128, 7, 16384, True, False, 2),
                 "dna_main_raw": (128, 7, 16384, False, True, 2),
                 "repeats_246": (246, 13, 4465, False, False, 4),
                 "shard_4096": (128, 7, 4096, True, False, 4)}


@pytest.mark.parametrize("case", sorted(CLUSTER_CASES))
def test_cluster_walk_matches_plain_on_card(cuda, case):
    """The 4 x 4 on-chip body where its plan takes a cluster: the plan's G
    asserted, one launch (counted), equal to the walk at every other
    cluster size and at G = 1 bit for bit, and to the plain version
    (counts equal, CLVs to 1e-5 of each site's max)."""
    taxa, seed, sites, per_rate, raw, want_g = CLUSTER_CASES[case]
    tree = random_utree([f"t{i}" for i in range(taxa)], seed=seed)
    part, eng = _engine(tree, sites, cuda, alphabet="ACGT-NRY",
                        rate_scalers=per_rate)
    if raw:
        rng = np.random.default_rng(7)
        for tip in sorted(tree.tips(), key=lambda t: t.clv_index)[::2]:
            part.set_tip_clv(tip.clv_index, rng.dirichlet(
                np.ones(4), size=sites).astype(np.float32))
        eng = TreeEngine(part, tree)
    args, kw = _inputs(part, eng)
    kw.update(rate_scalers=per_rate, tip_clvs=eng._tip_clvs())
    plan = _assert_fused_plan(part, kw["n_slots"],
                              ("on-chip", 2 if sites > 4159 else 4, want_g),
                              eng.fused_splits, raw)
    assert plan.smem_bytes < _kernels.fused_onchip_bytes(
        kw["n_slots"], 4 // plan.threads_per_site)
    before = fused.fused_traversal.launches
    got = fused.fused_traversal(*args, **kw)
    assert fused.fused_traversal.launches == before + 1
    assert _assert_clusters_equal(args, kw) == CLUSTER_SIZES
    ref = _kernels.launch_fused_traversal(
        args[0], args[1][None], args[2][None], 4, 4, kw["n_slots"],
        kw["threshold"], kw["factor"], per_rate, kw["tip_clvs"],
        plan=plan._replace(cluster=1, smem_bytes=_kernels.fused_onchip_bytes(
            kw["n_slots"], 4 // plan.threads_per_site)))
    want = fused.fused_traversal_reference(*args, **kw)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        assert torch.equal(g, r[0])
    for g, w in zip(got[2:], want[2:]):
        assert torch.equal(g, w)
    for g, w in zip(got[:2], want[:2]):
        site_max = w.abs().amax(dim=(0, 1)).clamp(min=1e-30)
        assert float(((g - w).abs() / site_max).max()) <= 1e-5


def _onchip_cluster_registers(log: str) -> dict:
    """{sites a thread: the most registers a thread} of the 4 x 4 on-chip
    body's cluster instantiations (fused_onchip<SPT, PER_RATE, true>) in a
    build's `-Xptxas -v` log."""
    import re

    regs, spt = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            m = re.search(r"fused_onchipILi(\d)ELb[01]ELb1E", m.group(1))
            spt = int(m.group(1)) if m else None
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and spt is not None:
            regs[spt] = max(regs.get(spt, 0), int(m.group(1)))
            spt = None
    return regs


def test_plan_registers_match_the_build(cuda):
    """The plan's residency (ops/_kernels.py:fused_resident_blocks) takes
    the cluster body's registers a thread from FUSED_REGISTERS: the built
    kernels must be allocated as many a warp at each sites-a-thread, so
    that a changed body or compiler fails here and does not silently
    change the cluster size the plan picks."""
    _kernels.library()
    regs = _onchip_cluster_registers(
        _kernels.library_path().with_suffix(".log").read_text())
    unit = _kernels.WARP_REGISTER_UNIT // 32
    assert sorted(regs) == sorted(_kernels.FUSED_REGISTERS)
    for spt, want in _kernels.FUSED_REGISTERS.items():
        assert -(-regs[spt] // unit) * unit == want, (spt, regs[spt])


def test_cluster_launch_refuses_a_bad_plan(cuda):
    """A cluster plan the C entry does not take (a cluster on the spill
    body) raises, and nothing falls back to another plan; a split into
    more blocks than a portable cluster holds raises before any launch."""
    tree = random_utree([f"t{i}" for i in range(128)], seed=7)
    part, eng = _engine(tree, 4096, cuda)
    args, kw = _inputs(part, eng)
    base = _kernels.device_fused_plan(cuda, 4, 4, kw["n_slots"], False,
                                      4096)
    launch = (args[0], args[1][None], args[2][None], 4, 4, kw["n_slots"],
              kw["threshold"], kw["factor"])
    with pytest.raises(RuntimeError, match="launch failed"):
        _kernels.launch_fused_traversal(
            *launch, plan=base._replace(plan="spill", cluster=2),
            splits=kw["splits"])
    with pytest.raises(ValueError, match="parts"):
        _kernels.launch_fused_traversal(*launch,
                                        plan=base._replace(cluster=16),
                                        splits=kw["splits"])
    # a cluster needs the tables' splits, and splits of other tables are
    # refused
    with pytest.raises(ValueError, match="splits"):
        _kernels.launch_fused_traversal(*launch,
                                        plan=base._replace(cluster=2))
    other = fused.FusedSplits(np.zeros((2, *args[2].shape), np.int32))
    with pytest.raises(ValueError, match="splits"):
        _kernels.launch_fused_traversal(*launch, splits=other)


# fused_traversal.cu's runtime-size body in float32 (fused_generic): name ->
# (rates, states, mode); shapes 'r1', 'r3', 'r8', 'r33' at 4 states, 's2',
# 's5' at 4 rates and 's15' at 2; modes: the walk as it is, 'per_rate'
# counts, 'raw' tip rows on every other tip, 'k3' three candidates, 'q3'
# three queries' codes in tip row 0 of two candidates, 'spill'
# GENERIC_SPILL_SLOTS slots ('s2' needs 2000); 'cat' the 80-taxon
# caterpillar, which rescales; 'wide' 24 taxa at 16384 sites, 4 warps a
# block (1 rate: 2)
GENERIC_SHAPES = {"r1": (1, 4), "r3": (3, 4), "r8": (8, 4), "r33": (33, 4),
                  "s2": (4, 2), "s5": (4, 5), "s15": (2, 15)}
GENERIC_CASES = [f"{shape}_{mode}" for shape in GENERIC_SHAPES
                 for mode in ("walk", "per_rate", "raw", "k3", "q3",
                              "spill")] + [
    "r3_cat", "r3_cat_per_rate", "s5_cat", "r1_wide", "r8_wide", "s5_wide"]


def _generic_case(case, device):
    """(partition, engine, tree, mode) of a GENERIC_CASES case."""
    shape, mode = case.split("_", 1)
    rates, states = GENERIC_SHAPES[shape]
    alphabet = {2: "AB-", 5: "ACGTX-", 15: LETTERS32[:15] + "-"}.get(
        states, "ACGT-NRY")
    taxa, sites = 16, 600 if rates < 33 else 200
    if mode.startswith("wide"):
        taxa, sites = 24, 16384
    tree = (_caterpillar(80) if mode.startswith("cat")
            else random_utree([f"t{i}" for i in range(taxa)], seed=3))
    part, eng = _engine(tree, sites, device, rates=rates, states=states,
                        alphabet=alphabet, rate_scalers="per_rate" in mode)
    if mode == "raw":
        rng = np.random.default_rng(7)
        for tip in sorted(tree.tips(), key=lambda t: t.clv_index)[::2]:
            part.set_tip_clv(tip.clv_index, rng.dirichlet(
                np.ones(states), size=sites).astype(np.float32))
        eng = TreeEngine(part, tree)
    return part, eng, tree, mode


@pytest.mark.parametrize("case", GENERIC_CASES)
def test_generic_body_matches_plain_on_card(cuda, case):
    """The runtime-size body of fused_traversal.cu in float32, one launch a
    call (the candidate and query forms too), against its plain version on
    the same CUDA tensors: counts equal, root CLVs to 1e-5 of each site's
    max, and logL through the likelihood epilogue to TOL_LOGL (5e-5); on
    the plan generic_plan gives it (spill at GENERIC_SPILL_SLOTS)."""
    part, eng, tree, mode = _generic_case(case, cuda)
    if mode in ("k3", "q3"):
        args, kw = _candidate_inputs(part, eng, tree, 3 if mode == "k3"
                                     else 2)
    else:
        args, kw = _inputs(part, eng)
        kw.update(rate_scalers=part.rate_scalers, tip_clvs=eng._tip_clvs())
    if mode == "q3":
        codes = args[0]
        kw.update(query_codes=codes[[3, 5, 7]].contiguous(), query_row=0)
    if mode == "spill":
        kw["n_slots"] = 2000 if part.states == 2 else GENERIC_SPILL_SLOTS
    walks = {"k3": 3, "q3": 6}.get(mode, 1)
    plan = _kernels.device_fused_plan(
        cuda, part.rate_cats, part.states, kw["n_slots"], part.rate_scalers,
        part.sites_padded, walks, kw["tip_clvs"] is not None)
    assert isinstance(plan, _kernels.GenericPlan)
    assert plan.plan == ("spill" if mode == "spill" else "on-chip")
    if mode.endswith("wide"):
        assert plan.warps == (2 if part.rate_cats == 1 else 4)
    before = fused.fused_traversal.launches
    got = fused.fused_traversal(*args, **kw)
    assert fused.fused_traversal.launches == before + 1
    want = fused.fused_traversal_reference(*args, **kw)
    torch.cuda.synchronize()
    lead = got[0].dim() - 3          # the candidate and query axes
    for g, w in zip(got[2:], want[2:]):
        assert g.shape == w.shape and torch.equal(g, w)
    for g, w in zip(got[:2], want[:2]):
        site_max = w.abs().amax(dim=(lead, lead + 1), keepdim=True)
        err = (g - w).abs() / site_max.clamp(min=1e-30)
        assert float(err.max()) <= 1e-5
    if mode.startswith("cat"):
        assert int(want[2].max()) > 0
    if mode in ("walk", "per_rate", "raw") or mode.startswith("cat"):
        lk = [float(_fused_loglikelihood(*eng._args(), traversal=t,
                                         **eng._fused_kw())[0])
              for t in (fused.fused_traversal,
                        fused.fused_traversal_reference)]
        assert abs(lk[0] - lk[1]) / abs(lk[1]) < 5e-5


def test_engine_on_card_matches_cpu_float64(cuda):
    tree = random_utree([f"t{i}" for i in range(24)], seed=5)
    _, gpu = _engine(tree, 3000, cuda)
    _, cpu = _engine(tree, 3000, "cpu", dtype=torch.float64)
    got, want = gpu.loglikelihood(), cpu.loglikelihood()
    assert abs(got - want) / abs(want) < 5e-5
    (gl, g1, g2), (wl, w1, w2) = gpu.newton_step(), cpu.newton_step()
    assert abs(gl - wl) / abs(wl) < 5e-5
    for g, w in ((g1, w1), (g2, w2)):
        assert abs(g - w) / max(abs(w), 10.0) < 5e-3


def test_kernel_wrapper_rejects_what_it_cannot_take(cuda):
    tree = random_utree([f"t{i}" for i in range(6)], seed=1)
    part, eng = _engine(tree, 64, cuda)
    (codes, pm, table), kw = _inputs(part, eng)
    bad = {
        "float64": (codes, pm.double(), table),
        "non-contiguous": (codes, pm.transpose(2, 3), table),
        "host table": (codes, pm, table.cpu()),
        "int64 codes": (codes.long(), pm, table),
    }
    for name, args in bad.items():
        with pytest.raises(ValueError):
            fused.fused_traversal(*args, **kw)


# the rows kernel's plan (ops/_kernels.py:rows_plan) for each case on an
# H100 (227 KB of shared memory a block): 8 rates x 32 states leave room
# beside P's two buffers for 3 slots of the 16-taxon tree's 4; 16 and 32
# rates x 32 states stage P in chunks of 8 rates
ROWS_SPILL_CASES = ("rates8_states32", "per_rate_rates8_states32",
                    "rates16_states32", "rates32_states32")


def _protein_case(case, device):
    """A rows-kernel engine: 16 taxa x 1000 sites unless named otherwise;
    'states17'/'states21' have P padded to 20/24 states; 'wide' (40003
    sites) runs two sites a thread, 626 blocks of 64 with a tail of 3."""
    tree = random_utree([f"t{i}" for i in range(16)], seed=3)
    if case == "caterpillar":
        return _engine(_caterpillar(80), 700, device, states=20,
                       alphabet=AA_NOISY)
    if case == "rates3":
        return _engine(tree, 1000, device, states=20, rates=3,
                       alphabet=AA_NOISY)
    if case in ("states16", "states32", "states17", "states21"):
        s = int(case[6:])
        return _engine(tree, 1000, device, states=s,
                       alphabet=LETTERS32[:s] + "-")
    if case in ROWS_SPILL_CASES:
        rates = int(case.split("rates")[-1].split("_")[0])
        return _engine(tree, 300, device, states=32, rates=rates,
                       alphabet=LETTERS32 + "-",
                       rate_scalers=case.startswith("per_rate"))
    if case == "wide":
        return _engine(tree, 40003, device, states=20, alphabet=AA_NOISY)
    return _engine(tree, 1000, device, states=20, alphabet=AA_NOISY)


@pytest.mark.parametrize("mode", ["highest", "bf16"])
@pytest.mark.parametrize("case", ["ragged", "caterpillar", "rates3",
                                  "states16", "states32", "states17",
                                  "states21", "wide", *ROWS_SPILL_CASES])
def test_rows_kernel_matches_plain_on_card(cuda, case, mode):
    from libpll2_tpu_torch.ops import _kernels

    part, eng = _protein_case(case, cuda)
    args, kw = _inputs(part, eng)
    kw.update(rate_scalers=part.rate_scalers)
    plan = _kernels.device_rows_plan(cuda, part.rate_cats, part.states,
                                     eng.fused_slots, part.rate_scalers,
                                     part.sites_padded, mxu=mode)
    if mode == "bf16":   # the tensor cores' 64-site tiles where P fits
        assert (plan.plan, plan.sites_per_thread) == (
            ("spill", 1) if case == "rates32_states32" else
            ("tc-spill", 2) if case in ROWS_SPILL_CASES else
            ("tc-on-chip", 2))
    else:
        assert plan.plan == ("spill" if case in ROWS_SPILL_CASES
                             else "on-chip")
        # 64-site tiles (two sites a thread) only where they fill the card
        assert plan.sites_per_thread == (2 if case == "wide" else 1)
    before = (fused.fused_traversal.launches,
              fused.fused_traversal_rows.launches)
    got = fused.fused_traversal(*args, mxu=mode, **kw)
    assert (fused.fused_traversal.launches,
            fused.fused_traversal_rows.launches) == (before[0],
                                                     before[1] + 1)
    want = fused.fused_traversal_reference(*args, mxu=mode, **kw)
    torch.cuda.synchronize()
    if case == "caterpillar":
        assert int(want[2].max()) > 0
    if mode == "bf16":
        # held at the logL level (module docstring)
        lk = [float(_fused_loglikelihood(*eng._args(), traversal=t,
                                         mxu=mode, **eng._fused_kw())[0])
              for t in (fused.fused_traversal,
                        fused.fused_traversal_reference)]
        assert abs(lk[0] - lk[1]) / abs(lk[1]) < 1e-4
        return
    for g, w in zip(got[2:], want[2:]):
        assert torch.equal(g, w)
    for g, w in zip(got[:2], want[:2]):
        site_max = w.abs().amax(dim=(0, 1)).clamp(min=1e-30)
        assert float(((g - w).abs() / site_max).max()) <= 1e-5
    # 'split' is JAX's three-term bf16 product, not 'highest''s exact one
    # (test_rows_kernel_rounded_modes_match_plain_on_card holds it)
    split = fused.fused_traversal(*args, mxu="split", **kw)
    assert not torch.equal(split[0], got[0])


# the rows kernel's rounded modes in every form it takes: one topology
# (16 x 1000 AA unless named: `_protein_case`; 'rates1' one category),
# per-rate counts and raw tips (`_mode_engine`), 3 and 130 candidates, 3
# queries x 43 edges, 12 slots (more than the tensor cores' layout holds
# on chip: their slots in device memory), 8 rates per rate and 16 rates x
# 32 states (the same), and 32 rates x 32 states (P's atoms do not fit:
# the CUDA cores' spill plan); the plan each must run
ROUNDED_FORMS = {"walk": "tc-on-chip", "rates1": "tc-on-chip",
                 "rates3": "tc-on-chip", "states16": "tc-on-chip",
                 "states17": "tc-on-chip", "states21": "tc-on-chip",
                 "states32": "tc-on-chip", "caterpillar": "tc-on-chip",
                 "wide": "tc-on-chip", "per_rate": "tc-on-chip",
                 "raw": "tc-on-chip", "raw_per_rate": "tc-on-chip",
                 "k3": "tc-on-chip", "k130": "tc-on-chip",
                 "q3": "tc-on-chip", "slots12": "tc-spill",
                 "spill": "tc-spill", "spill_per_rate": "tc-spill",
                 "spill_fma": "spill"}


def _rounded_inputs(form, device):
    """(partition, engine, args, kw) of one of ROUNDED_FORMS."""
    if form == "q3":
        placer, queries = _placement_problem(20, 24, 600, device)
        args, kw = _query_inputs(placer, queries, 3, 43)
        return placer.partition, placer._ensure_engine(), args, kw
    if form in ("k3", "k130"):
        part, eng, tree = _candidate_engine("aa", device)
        args, kw = _candidate_inputs(part, eng, tree, int(form[1:]))
        return part, eng, args, kw
    if form in ("per_rate", "raw", "raw_per_rate"):
        part, eng = _mode_engine({"per_rate": "aa_rate_cat", "raw": "aa_raw",
                                  "raw_per_rate": "aa_raw_rate_r3"}[form],
                                 device)
    elif form == "rates1":
        part, eng = _engine(random_utree([f"t{i}" for i in range(16)],
                                         seed=3), 1000, device, states=20,
                            rates=1, alphabet=AA_NOISY)
    else:
        part, eng = _protein_case({"spill": "rates16_states32",
                                   "spill_per_rate":
                                   "per_rate_rates8_states32",
                                   "spill_fma": "rates32_states32"}.get(
                                       form, form), device)
    args, kw = _inputs(part, eng)
    kw.update(rate_scalers=part.rate_scalers, tip_clvs=eng._tip_clvs())
    if form == "slots12":
        kw["n_slots"] = 12
    return part, eng, args, kw


@pytest.mark.parametrize("mode", ["split", "bf16"])
@pytest.mark.parametrize("form", sorted(ROUNDED_FORMS))
def test_rows_kernel_rounded_modes_match_plain_on_card(cuda, form, mode):
    """The rows kernel in 'split' and 'bf16' (the tensor cores, or the
    spill plan's rounded FMAs) against the plain version of the same mode
    on the same inputs, one launch (module docstring's tolerances)."""
    part, eng, args, kw = _rounded_inputs(form, cuda)
    walks = args[2].shape[0] if args[2].dim() == 3 else 1
    if kw.get("query_codes") is not None:
        walks *= kw["query_codes"].shape[0]
    plan = _kernels.device_rows_plan(cuda, part.rate_cats, part.states,
                                     kw["n_slots"],
                                     kw.get("rate_scalers", False),
                                     args[0].shape[1], walks, mxu=mode)
    assert plan.plan == ROUNDED_FORMS[form]
    before = fused.fused_traversal_rows.launches
    got = fused.fused_traversal(*args, mxu=mode, **kw)
    assert fused.fused_traversal_rows.launches == before + 1
    want = fused.fused_traversal_reference(*args, mxu=mode, **kw)
    torch.cuda.synchronize()
    agree = None
    for g, w in zip(got[2:], want[2:]):
        assert g.shape == w.shape
        diff = (g.long() - w.long()).abs()
        assert int((diff > 0).sum()) <= 8 and int(diff.max()) <= 1
        # the sites whose counts agree (per rate: in every rate)
        same = diff == 0 if not kw.get("rate_scalers") else \
            (diff == 0).all(dim=-2)
        agree = same if agree is None else agree & same
    for g, w in zip(got[:2], want[:2]):
        assert bool(torch.isfinite(g).all())
        site_max = w.abs().amax(dim=(-3, -2)).clamp(min=1e-30)
        err = ((g - w).abs().amax(dim=(-3, -2)) / site_max)[agree]
        assert float(err.max()) <= (5e-4 if mode == "split" else 2.0 ** -4)
    if form == "caterpillar":
        assert int(want[2].max()) > 0
    if args[2].dim() == 2 and form != "slots12":   # one topology: the logL
        lk = [float(_fused_loglikelihood(*eng._args(), traversal=t,
                                         mxu=mode, **eng._fused_kw())[0])
              for t in (fused.fused_traversal,
                        fused.fused_traversal_reference)]
        assert abs(lk[0] - lk[1]) / abs(lk[1]) < 1e-4


def test_protein_engine_on_card_matches_cpu_float64(cuda):
    tree = random_utree([f"t{i}" for i in range(24)], seed=5)
    _, gpu = _engine(tree, 3000, cuda, states=20, alphabet=AA_NOISY)
    _, cpu = _engine(tree, 3000, "cpu", dtype=torch.float64, states=20,
                     alphabet=AA_NOISY)
    before = fused.fused_traversal_rows.launches
    got, want = gpu.loglikelihood(), cpu.loglikelihood()
    assert abs(got - want) / abs(want) < 5e-5
    for _ in range(3):
        (gl, g1, g2), (wl, w1, w2) = gpu.newton_step(), cpu.newton_step()
        assert abs(gl - wl) / abs(wl) < 5e-5
        for g, w in ((g1, w1), (g2, w2)):
            assert abs(g - w) / max(abs(w), 10.0) < 5e-3
    assert fused.fused_traversal_rows.launches == before + 4


def test_rows_wrapper_rejects_what_it_cannot_take(cuda):
    tree = random_utree([f"t{i}" for i in range(6)], seed=1)
    part, eng = _engine(tree, 64, cuda, states=20, alphabet=AA_NOISY)
    (codes, pm, table), kw = _inputs(part, eng)
    bad = {
        "float64": ((codes, pm.double(), table), kw),
        "non-contiguous": ((codes, pm.transpose(2, 3), table), kw),
        "host table": ((codes, pm, table.cpu()), kw),
        "int64 codes": ((codes.long(), pm, table), kw),
        "33 states": ((codes, torch.zeros(pm.shape[:2] + (33, 33),
                                          device=cuda), table),
                      dict(kw, states=33)),
    }
    for name, (args, kwargs) in bad.items():
        with pytest.raises(ValueError):
            fused.fused_traversal_rows(*args, **kwargs)


LEVEL_CASES = ["ragged", "rates3", "states20", "states32", "caterpillar",
               "no_scaler", "partial", "self_child", "states5", "states2",
               "rates16_states32", "states20_wide", "per_rate_states20_wide",
               "states32_wide", "dna_wide", "dna_narrow", "dna_even_sites",
               "dna_odd_sites", "per_rate_dna_wide", "dna_self_child",
               "states33", "states40", "states61", "per_rate_states61",
               "rates1_states61", "caterpillar61", "self_child61",
               "rates5_states61", "rates10_states40", "ragged_states61",
               "caterpillar_spread61"]
# the 64-state body's cases (csrc/states64.cuh, ops/_kernels.py:
# level64_plan): 5 rates (a cluster of 5 blocks, not a power of two), 10
# rates at 40 states (a cluster of 8, two blocks taking 2 rates each), 3
# rates, 1001 sites (a ragged last tile, and rows off the 16-byte grain:
# the one-entry copies), and the 80-taxon caterpillar under rates far
# apart (S64_SPREAD_RATES), whose per-site rescale decisions need the
# other rates' maxima: their states, rates and sites
S64_CASES = {"rates5_states61": (61, 5, 1000), "rates10_states40": (40, 10, 1000),
             "rates3_states61": (61, 3, 1000), "ragged_states61": (61, 4, 1001),
             "caterpillar_spread61": (61, 4, 1000)}
S64_SPREAD_RATES = [0.05, 0.35, 1.0, 2.6]
# The 4x4 variant's DNA cases on the 16-taxon tree (levels of 5, 3, 3, 2
# and 1 ops): their sites, and the sites a lane their levels take on a
# 132-SM H100 (ops/_kernels.py:level_fixed_plan): 60000 sites (4, 16-byte
# accesses, runs of up to 5 tiles a block), 20000 (4, and 2 on the one-op
# levels, which would give an SM fewer than 2 tiles at 4), 60002 (2: S % 4
# == 2), 60001 (1, the scalar layout, with a ragged last tile), and at 700
# or 1000 sites every level narrowed to 1
DNA_LEVEL_CASES = {"dna_wide": (60000, {4}), "dna_narrow": (20000, {4, 2}),
                   "dna_even_sites": (60002, {2}),
                   "dna_odd_sites": (60001, {1}),
                   "per_rate_dna_wide": (60000, {4}),
                   "dna_self_child": (60000, {4}), "caterpillar": (700, {1}),
                   "ragged": (1000, {1}), "no_scaler": (1000, {1}),
                   "partial": (1000, {1})}


def _level_case(case, device, dtype=torch.float32):
    """(partition with P-matrices set, the op list to run, the full list
    that must run first or None) for one level-kernel case. The runtime-size
    variant takes 'states20' exactly, 'states5' and 'states2' padded, and
    'rates16_states32' (per-rate counts) with P's 128 KB staged in chunks;
    33, 40 and 61 states take its 64-state instantiation (per site, per
    rate, one rate, a caterpillar that rescales, an op that writes its own
    child).
    It picks its threads from a level's ops x sites and the card's SM count:
    at 60000 sites ('_wide') the 16-taxon tree's levels of 5, 3, 3, 2 and 1
    ops take, on a 132-SM H100, what the 128 x 8192 protein tree's levels
    take (20 states: two sites a thread on the widest level, one site with
    its rates over 2 threads, then over 4; other counts over 1, 2, 4)."""
    tree = random_utree([f"t{i}" for i in range(16)], seed=3)
    kw = dict(dtype=dtype)
    sites = DNA_LEVEL_CASES.get(case, (1000,))[0]
    if case.endswith("_wide"):
        case, sites = case[:-len("_wide")], 60000
    if case.startswith("per_rate_"):
        case, kw["rate_scalers"] = case[len("per_rate_"):], True
    if case == "dna_self_child":
        kw.update(alphabet="ACGT")
    elif case.startswith("dna"):
        case = "dna"
    if case in S64_CASES:
        states, rates, sites = S64_CASES[case]
        if case == "caterpillar_spread61":
            tree = _caterpillar(80)
        kw.update(states=states, rates=rates,
                  alphabet=LETTERS64[:states] + "-")
    elif case == "caterpillar":
        tree, kw = _caterpillar(80), dict(kw, alphabet="ACGT")
    elif case in ("caterpillar61", "self_child61", "rates1_states61"):
        if case == "caterpillar61":
            tree = _caterpillar(80)
        kw.update(states=61, alphabet=LETTERS64[:61] + "-",
                  rates=1 if case.startswith("rates1") else 4)
        case = case[:-2] if case != "rates1_states61" else case
    elif case == "rates3":
        kw["rates"] = 3
    elif case == "self_child":
        kw.update(states=20, alphabet=AA_NOISY)
    elif case == "rates16_states32":
        kw.update(states=32, rates=16, alphabet=LETTERS32 + "-",
                  rate_scalers=True)
    elif case.startswith("states"):
        s = int(case[6:])
        kw.update(states=s, alphabet={20: AA_NOISY, 5: "ACGTX-"}.get(
            s, LETTERS64[:s] + "-"))
    part, _ = _engine(tree, sites, device, **kw)
    if case == "caterpillar_spread61":
        part.set_category_rates(S64_SPREAD_RATES)
    ops, br, pidx = create_operations(traverse(tree.vroot))
    part.update_prob_matrices([0] * part.rate_cats, pidx, br)
    if case == "no_scaler":
        for op in ops[::3]:
            op.parent_scaler_index = -1
    if case == "partial":
        return part, ops[len(ops) // 2:], ops
    if case in ("self_child", "dna_self_child"):
        return part, [self_child_op(ops, part.tips)], ops
    return part, ops, None


def _level_lanes(part, ops):
    """The sites a lane each level of `ops` launches the 4x4 variant with
    (the layout the wrapper passes and the kernel's entry checks)."""
    tables = levels.pack_pallas_levels(ops, part.tips, part.scale_buffers + 1,
                                       part.scale_buffers)
    aligned = (part.clv.data_ptr() | part.scale_buffer.data_ptr()) % 16 == 0
    return {_kernels.level_fixed_plan(
        t.shape[1], part.sites_padded, _kernels.device_sm_count(part.device),
        aligned, part.rate_scalers).sites_per_lane for t in tables}


def _run_levels(part, ops, level):
    tables = levels.tables_to_device(levels.pack_pallas_levels(
        ops, part.tips, part.scale_buffers + 1, part.scale_buffers),
        part.device)
    levels.update_partials_kernel(part.clv, part.scale_buffer, part.pmatrix,
                                  tables, part.scale_threshold,
                                  part.scale_factor, level=level)
    return len(tables)


@pytest.mark.parametrize("case", LEVEL_CASES)
def test_level_kernel_matches_plain_on_card(cuda, case):
    part, ops, first = _level_case(case, cuda)
    if first is not None:
        _run_levels(part, first, levels.level_update)
    clv, sc = part.clv.clone(), part.scale_buffer.clone()
    before = levels.level_update.launches
    n = _run_levels(part, ops, levels.level_update)
    assert levels.level_update.launches == before + n
    got_clv, got_sc = part.clv.clone(), part.scale_buffer.clone()
    part.clv.copy_(clv)
    part.scale_buffer.copy_(sc)
    _run_levels(part, ops, levels.level_update_reference)
    torch.cuda.synchronize()
    k = part.scale_buffers
    assert torch.equal(got_sc[:k], part.scale_buffer[:k])
    assert not got_sc[k + 1].any()
    want = part.clv[:part.nodes]
    site_max = want.abs().amax(dim=(1, 2), keepdim=True).clamp(min=1e-30)
    rel = ((got_clv[:part.nodes] - want).abs() / site_max).max()
    assert float(rel) <= 1e-5
    if case in ("caterpillar", "caterpillar61", "caterpillar_spread61"):
        assert int(part.scale_buffer[:k].max()) > 0
    if case in DNA_LEVEL_CASES:
        assert _level_lanes(part, ops) == DNA_LEVEL_CASES[case][1]
    if case == "caterpillar_spread61":
        assert _rates_rescale_apart(cuda, case)


def _rates_rescale_apart(device, case):
    """Whether the level case's rates, counted each on its own (per-rate
    scalers, the plain version), rescale at different ops for some site:
    then a per-site decision taken from one rate's maximum alone would
    differ from the site's."""
    part, ops, _ = _level_case("per_rate_" + case, device)
    _run_levels(part, ops, levels.level_update_reference)
    sc = part.scale_buffer[:part.scale_buffers]       # [K, R, S]
    return bool((sc != sc[:, :1]).any())


@pytest.mark.parametrize("states", [4, 20, 61])
def test_levels_kernel_engine_on_card_matches_cpu_float64(cuda, states):
    tree = random_utree([f"t{i}" for i in range(24)], seed=5)
    kw = {4: {}, 20: dict(states=20, alphabet=AA_NOISY),
          61: dict(states=61, alphabet=LETTERS64[:61] + "-")}[states]
    gpu_part, _ = _engine(tree, 3000, cuda, **kw)
    cpu_part, _ = _engine(tree, 3000, "cpu", dtype=torch.float64, **kw)
    gpu = TreeEngine(gpu_part, tree, pallas="levels-kernel")
    cpu = TreeEngine(cpu_part, tree, pallas="levels-kernel")
    assert gpu.execution_path == "levels-kernel"
    before = levels.level_update.launches
    got, want = gpu.loglikelihood(), cpu.loglikelihood()
    assert levels.level_update.launches == before + len(gpu._ops)
    assert abs(got - want) / abs(want) < 5e-5
    for _ in range(3):
        (gl, g1, g2), (wl, w1, w2) = gpu.newton_step(), cpu.newton_step()
        assert abs(gl - wl) / abs(wl) < 5e-5
        for g, w in ((g1, w1), (g2, w2)):
            assert abs(g - w) / max(abs(w), 10.0) < 5e-3


def test_step_by_step_api_on_card_matches_cpu_float64(cuda):
    tree = random_utree([f"t{i}" for i in range(24)], seed=5)
    r = tree.vroot
    edge = (r.clv_index, r.scaler_index, r.back.clv_index,
            r.back.scaler_index, r.pmatrix_index, [0] * 4)
    out = []
    for device, dtype in ((cuda, torch.float32), ("cpu", torch.float64)):
        part, _ = _engine(tree, 3000, device, dtype=dtype)
        ops, br, pidx = create_operations(traverse(tree.vroot))
        part.update_prob_matrices([0] * 4, pidx, br)
        before = levels.level_update.launches
        part.update_partials(ops)
        if device == cuda:
            assert levels.level_update.launches > before
        st = part.update_sumtable(*edge[:1], edge[2], edge[1], edge[3],
                                  edge[5])
        out.append((part.compute_edge_loglikelihood(*edge),
                    part.compute_likelihood_derivatives(st, [0] * 4, 0.1)))
    (gl, (g1, g2)), (wl, (w1, w2)) = out
    assert abs(gl - wl) / abs(wl) < 5e-5
    for g, w in ((g1, w1), (g2, w2)):
        assert abs(g - w) / max(abs(w), 10.0) < 5e-3


def test_level_wrapper_rejects_what_it_cannot_take(cuda):
    part, ops, _ = _level_case("ragged", cuda)
    table = levels.tables_to_device(levels.pack_pallas_levels(
        ops, part.tips, part.scale_buffers + 1, part.scale_buffers),
        cuda)[0]
    n = part.clv.shape[0]
    clv2d = part.clv.view(n, -1, part.sites)
    args = (clv2d, part.scale_buffer, part.pmatrix, table)
    kw = dict(rates=4, states=4, threshold=part.scale_threshold,
              factor=part.scale_factor)
    bad = {
        "float64": ((clv2d.double(),) + args[1:], kw),
        "non-contiguous P": (args[:2] + (part.pmatrix.transpose(2, 3),)
                             + args[3:], kw),
        "host table": (args[:3] + (table.cpu(),), kw),
        "int64 table": (args[:3] + (table.long(),), kw),
        "65 states": (args, dict(kw, states=65)),
    }
    for name, (a, k) in bad.items():
        with pytest.raises(ValueError):
            levels.level_update(*a, **k)


POOL_CASES = ["dna", "rates3", "aa20", "caterpillar", "partial",
              "no_scaler", "identity", "states5", "states17", "states32",
              "aa20_per_rate", "rates3_per_rate", "rates1", "wide_aa",
              "mixed_widths", "war_serial", "back_to_back", "caterpillar80",
              "big_grid", "dna_levels", "states33", "states40", "states61",
              "states61_per_rate", "states61_rates1", "caterpillar61",
              "states61_rates5", "states40_rates10", "states61_rates3",
              "caterpillar_spread61"]
# the runtime-size variant's threads a column (ops/_kernels.py:pool_plan,
# read from each level's launch in the plan): a column's rates split over
# the largest power of two up to 4 that the rates fill, so 'rates1' takes
# 1, the 3-rate cases 2 and the 4-rate cases 4; 'wide_aa' (128 x 16384
# simulated amino acids, levels 20,480-196,608 columns wide) runs blocks
# over runs of tiles; 'mixed_widths' (64 x 4096 random DNA, 3 rates) holds
# a level whose ops differ 16x in width; the 64-state body (33-64 states)
# one rate warp, a block a rate and a tile's rates in a cluster (the test
# checks the clusters); None: the 4x4 traversal kernel
POOL_LAYOUTS = {"rates3": {2}, "aa20": {4}, "states5": {4},
                "states17": {4}, "states32": {4}, "aa20_per_rate": {4},
                "rates3_per_rate": {2}, "rates1": {1}, "wide_aa": {4},
                "mixed_widths": {2}, "states33": {1}, "states40": {1},
                "states61": {1}, "states61_per_rate": {1},
                "states61_rates1": {1}, "caterpillar61": {1},
                "states61_rates5": {1}, "states40_rates10": {1},
                "states61_rates3": {1}, "caterpillar_spread61": {1}}


def _repeats_partition(tree, sites, device, states=4, rates=4, seed=11,
                       conserved=True, dtype=torch.float32, **options):
    """A site-repeats partition of an alignment simulated on `tree`
    (branches shortened to 0.15 len + 0.001 when `conserved`), or of random
    columns (`conserved` False: repeats switch off at most inner nodes);
    DNA, LG amino acids or `_charmap`'s letters with equal rates.
    `options` (rate_scalers) go to Partition."""
    if conserved:
        seen = set()
        for nd in tree.nodes():
            for h in ([nd] if nd.is_tip() else list(nd.ring())):
                if h.back is not None and id(h) not in seen:
                    seen.update((id(h), id(h.back)))
                    h.length = h.back.length = h.length * 0.15 + 0.001
        freqs = [1 / states] * states
        headers, seqs = simulate_alignment(
            tree, sites, freqs, [1.0] * (states * (states - 1) // 2),
            alpha=0.8, seed=seed,
            alphabet=None if states in (4, 20) else LETTERS64[:states])
    else:
        headers, seqs = random_alignment(tree.tip_count, sites, seed=seed)
    by = dict(zip(headers, seqs))
    part = Partition(tree.tip_count, tree.inner_count, states, sites, 1,
                     tree.edge_count, rates, tree.inner_count, device=device,
                     dtype=dtype, site_repeats=True, **options)
    tips = list(tree.tips())
    charmap = {4: maps.map_nt, 20: maps.map_aa}.get(states)
    part.set_tip_states_batch(_charmap(states) if charmap is None
                              else charmap, [by[t.label] for t in tips],
                              [t.clv_index for t in tips])
    if states == 20:
        load_aa_model(part, "lg")
    elif states == 4:
        part.set_frequencies(0, [0.3, 0.25, 0.2, 0.25])
        part.set_subst_params(0, [1.2, 3.0, 0.8, 1.1, 2.6, 1.0])
    else:
        rng = np.random.default_rng(seed)
        part.set_frequencies(0, rng.dirichlet(np.ones(states) * 10))
        part.set_subst_params(0, rng.uniform(0.5, 2.0,
                                             states * (states - 1) // 2))
    part.set_category_rates(compute_gamma_cats(0.8, rates))
    return part


def _pool_case(case, device):
    """(repeats partition with P-matrices set, the op list to run, the full
    list that must run first or None) for one pool-kernel case."""
    tree = random_utree([f"t{i}" for i in range(24)], seed=11)
    kw = {"rates3": dict(rates=3), "rates1": dict(rates=1),
          "aa20": dict(states=20),
          "states5": dict(states=5), "states17": dict(states=17),
          "states32": dict(states=32), "states33": dict(states=33),
          "states40": dict(states=40), "states61": dict(states=61),
          "states61_per_rate": dict(states=61, rate_scalers=True),
          "states61_rates1": dict(states=61, rates=1),
          "states61_rates5": dict(states=61, rates=5),
          "states40_rates10": dict(states=40, rates=10),
          "states61_rates3": dict(states=61, rates=3),
          "aa20_per_rate": dict(states=20, rate_scalers=True)}.get(case, {})
    sites = 600
    if case == "caterpillar":
        tree, sites = _caterpillar(150), 300
    elif case == "rates3_per_rate":
        tree, sites = _caterpillar(150), 300
        kw = dict(rates=3, rate_scalers=True)
    elif case == "identity":
        tree, sites = random_utree([f"t{i}" for i in range(32)], seed=11), \
            2048
        kw = dict(conserved=False)
    elif case == "wide_aa":
        tree, sites = random_utree([f"t{i}" for i in range(128)], seed=11), \
            16384
        headers, seqs = simulate_alignment(tree, sites, np.full(20, 0.05),
                                           np.ones(190), alpha=0.9, seed=11)
        part = _aa_partition(tree, dict(zip(headers, seqs)), sites, device)
        ops, br, pidx = create_operations(traverse(tree.vroot))
        part.update_prob_matrices([0] * part.rate_cats, pidx, br)
        return part, ops, None
    elif case == "mixed_widths":
        tree, sites = random_utree([f"t{i}" for i in range(64)], seed=11), \
            4096
        kw = dict(rates=3, conserved=False)
    elif case == "caterpillar80":
        tree, sites = _caterpillar(80), 1000
    elif case in ("caterpillar61", "caterpillar_spread61"):
        tree, sites, kw = _caterpillar(150), 300, dict(states=61)
    elif case == "big_grid":
        kw = dict(rate_scalers=True)
    part = _repeats_partition(tree, sites, device, **kw)
    if case == "caterpillar_spread61":
        part.set_category_rates(S64_SPREAD_RATES)
    ops, br, pidx = create_operations(traverse(tree.vroot))
    part.update_prob_matrices([0] * part.rate_cats, pidx, br)
    if case == "no_scaler":
        for op in ops[::3]:
            op.parent_scaler_index = -1
    if case == "partial":
        return part, ops[len(ops) // 2:], ops
    if case == "war_serial":
        # the traversal, then the first half of its postorder again with
        # each op's P-matrices swapped: it rewrites nodes whose parents the
        # traversal read and it leaves (write after read, in the final pools)
        again = [copy.copy(op) for op in ops[:len(ops) // 2]]
        for op in again:
            op.child1_matrix_index, op.child2_matrix_index = \
                op.child2_matrix_index, op.child1_matrix_index
        return part, ops + again, None
    return part, ops, None


def _aa_partition(tree, by, sites, device):
    """An LG+G4 site-repeats partition of `by` (amino acids) on `device`."""
    part = Partition(tree.tip_count, tree.inner_count, 20, sites, 1,
                     tree.edge_count, 4, tree.inner_count, device=device,
                     site_repeats=True)
    tips = list(tree.tips())
    part.set_tip_states_batch(maps.map_aa, [by[t.label] for t in tips],
                              [t.clv_index for t in tips])
    load_aa_model(part, "lg")
    part.set_category_rates(compute_gamma_cats(0.9, 4))
    return part


def _run_pool(part, ops, level=None):
    """`ops` on the partition's pools through update_partials_pool with
    `level` (None: the plan's kernels); returns the launches the wrapper
    makes (the 4x4 traversal kernel: one; else one a level, as with a
    given `level`)."""
    plan = part._pool_plan(ops, True)
    pool.update_partials_pool(part.clv_flat, part.sc_flat, part.pmatrix,
                              plan, part.scale_threshold, part.scale_factor,
                              level=level)
    return (1 if level is None and plan.traversal is not None
            else len(plan.tables))


def _pool_layouts(part):
    """The threads a column the levels of the partition's plan launch
    with (the runtime-size variant), or None (the 4x4 traversal kernel)."""
    plan = part._repeat_schedule
    if plan.traversal is not None:
        return None
    return {launch.rate_threads for launch in plan.launches}


@pytest.mark.parametrize("case", POOL_CASES)
def test_pool_kernel_matches_plain_on_card(cuda, case):
    """The wrapper's launches: one a traversal at 4x4 (the traversal
    kernel), one a level otherwise and in 'dna_levels', where each level
    of the 4x4 plan is its own launch. After a traversal its counters show
    every tile of every op done and each block's one draw past the
    tickets. 'back_to_back' runs two traversals under different
    P-matrices (the counters zeroed before each); 'big_grid' launches 4
    blocks a ticket, past the card's resident blocks; 'caterpillar80'
    waits through 78 dependent levels."""
    part, ops, first = _pool_case(case, cuda)
    if first is not None:
        _run_pool(part, first)
    plan = part._pool_plan(ops, True)     # lays the pool out, computes none
    if case == "big_grid":
        trav = plan.traversal
        part._repeat_schedule = plan._replace(traversal=trav._replace(
            plan=trav.plan._replace(blocks=4 * trav.plan.tiles)))
    p_sets = [lambda: None]
    if case == "back_to_back":
        p0 = part.pmatrix.clone()
        p_sets = [lambda f=f: part.pmatrix.copy_(p0 * f) for f in (1.0, 0.9)]
    level = pool.pool_update if case == "dna_levels" else None
    clv, sc = part.clv_flat.clone(), part.sc_flat.clone()
    before, n = pool.pool_update.launches, 0
    for set_p in p_sets:
        set_p()
        n += _run_pool(part, ops, level)
    assert pool.pool_update.launches == before + n
    if (part.rate_cats, part.states) == (4, 4):
        assert n == len(p_sets) * (1 if level is None else len(plan.tables))
    if level is None and plan.traversal is not None:
        trav = part._repeat_schedule.traversal
        stride = _kernels.POOL_COUNTER_STRIDE
        counts = trav.counters.view(-1, stride)[:, 0].cpu()
        tiles = torch.bincount(trav.tickets[:, 0].long().cpu(),
                               minlength=trav.table.shape[1])
        assert int(counts[0]) == trav.plan.tiles + trav.plan.blocks
        assert torch.equal(counts[1:].long(), tiles)
    got_clv, got_sc = part.clv_flat.clone(), part.sc_flat.clone()
    part.clv_flat.copy_(clv)
    part.sc_flat.copy_(sc)
    for set_p in p_sets:
        set_p()
        _run_pool(part, ops, pool.pool_update_reference)
    torch.cuda.synchronize()
    lay = part._flat
    keep = torch.ones_like(got_sc, dtype=torch.bool)
    keep[..., lay.sc_trash:lay.sc_zero] = False
    assert torch.equal(got_sc[keep], part.sc_flat[keep])
    assert not got_sc[..., lay.sc_zero:].any()
    want = part.clv_flat
    col_max = want.abs().amax(dim=(0, 1), keepdim=True).clamp(min=1e-30)
    assert float(((got_clv - want).abs() / col_max).max()) <= 1e-5
    if case in ("caterpillar", "rates3_per_rate", "caterpillar80",
                "caterpillar61", "caterpillar_spread61"):
        assert int(part.sc_flat[..., :lay.sc_trash].max()) > 0
    if part.states >= _kernels.WIDE_STATES_MIN:
        # the 64-state body: a tile's rates in one cluster
        assert {launch.cluster for launch in plan.launches} == {
            min(part.rate_cats, _kernels.STATES64_MAX_CLUSTER)}
    if case == "caterpillar80":
        assert len(plan.tables) == 78
    if case == "identity":
        assert max(int(t[8].max()) for t in plan.tables) == lay.caps.max()
    if case == "mixed_widths":
        assert any(int(t[8].max()) >= 16 * int(t[8].min())
                   for t in part._repeat_schedule.tables)
    assert _pool_layouts(part) == POOL_LAYOUTS.get(case)


@pytest.mark.parametrize("pallas", ["auto", "pool"])
def test_repeats_engine_on_card_matches_cpu_float64(cuda, pallas):
    out = []
    for device, dtype in ((cuda, torch.float32), ("cpu", torch.float64)):
        tree = random_utree([f"t{i}" for i in range(24)], seed=5)
        part = _repeats_partition(tree, 3000, device, dtype=dtype)
        out.append(TreeEngine(part, tree, pallas=pallas))
    gpu, cpu = out
    assert gpu.execution_path == ("repeats-dense-fused" if pallas == "auto"
                                  else "pool-pallas")
    before = pool.pool_update.launches
    got, want = gpu.loglikelihood(), cpu.loglikelihood()
    if pallas == "pool":
        # the 4x4 traversal kernel: one launch a traversal
        assert pool.pool_update.launches == before + 1
    assert abs(got - want) / abs(want) < 5e-5
    for _ in range(3):
        (gl, g1, g2), (wl, w1, w2) = gpu.newton_step(), cpu.newton_step()
        assert abs(gl - wl) / abs(wl) < 5e-5
        for g, w in ((g1, w1), (g2, w2)):
            assert abs(g - w) / max(abs(w), 10.0) < 5e-3


@pytest.mark.parametrize("storage", ["dense", "repeats"])
def test_float64_engine_on_card_matches_cpu_float64(cuda, storage):
    """A float64 partition on the card takes the routes JAX reports for
    float64, 'levels' and 'pool' (the kernels are float32): no kernel
    launches, and logL within 1e-12 and d1/d2 within 1e-10 of float64 on
    the CPU; the step-by-step API (a full traversal, then a partial one)
    runs the plain version too, its CLVs within 1e-12 of the CPU's."""
    out = []
    for device in (cuda, "cpu"):
        tree = random_utree([f"t{i}" for i in range(24)], seed=5)
        if storage == "dense":
            part, _ = _engine(tree, 3000, device, dtype=torch.float64)
        else:
            part = _repeats_partition(tree, 3000, device,
                                      dtype=torch.float64)
        out.append((part, TreeEngine(part, tree)))
    (gpart, gpu), (cpart, cpu) = out
    assert gpu.execution_path == ("levels" if storage == "dense" else "pool")
    counts = (fused.fused_traversal.launches, levels.level_update.launches,
              pool.pool_update.launches)
    got, want = gpu.loglikelihood(), cpu.loglikelihood()
    assert abs(got - want) / abs(want) < 1e-12
    for _ in range(3):
        (gl, g1, g2), (wl, w1, w2) = gpu.newton_step(), cpu.newton_step()
        assert abs(gl - wl) / abs(wl) < 1e-12
        for g, w in ((g1, w1), (g2, w2)):
            assert abs(g - w) / max(abs(w), 1e-3) < 1e-10
    ops, br, pidx = create_operations(traverse(tree.vroot))
    for part in (gpart, cpart):
        part.update_prob_matrices([0] * part.rate_cats, pidx, br)
        part.update_partials(ops)
        part.update_partials(ops[len(ops) // 2:])
    assert counts == (fused.fused_traversal.launches,
                      levels.level_update.launches,
                      pool.pool_update.launches)
    if storage == "dense":
        n = gpart.nodes    # the last row is scratch
        assert torch.allclose(gpart.clv[:n].cpu(), cpart.clv[:n],
                              rtol=1e-12, atol=0.0)


def test_float64_tensors_do_not_enter_the_kernels(cuda):
    """The level and pool wrappers refuse float64 CUDA tensors; the callers
    take the plain versions for them (ops/levels.py:level_for,
    ops/pool.py:pool_for)."""
    x = torch.zeros(2, device=cuda, dtype=torch.float64)
    assert levels.level_for(x) is levels.level_update_reference
    assert pool.pool_for(x) is pool.pool_update_reference
    assert levels.level_for(x.float()) is levels.level_update
    assert pool.pool_for(x.float()) is pool.pool_update


def test_pool_wrapper_needs_the_tile_map(cuda):
    """The runtime-size variant launches on a level's tile map and its
    launch only: no map, one on the host, of another type or shape, or no
    launch or another level's is refused."""
    part, ops, _ = _pool_case("aa20", cuda)
    plan = part._pool_plan(ops, True)
    args = (part.clv_flat.view(80, -1), part.sc_flat, part.pmatrix,
            plan.tables[0], plan.gl, plan.gr)
    kw = dict(rates=4, states=20, threshold=part.scale_threshold,
              factor=part.scale_factor)
    tiles, launch = plan.tiles[0], plan.launches[0]
    for bad in (None, tiles.cpu(), tiles.long(), tiles.reshape(-1),
                tiles[:0]):
        with pytest.raises(ValueError):
            pool.pool_update(*args, **kw, tiles=bad, launch=launch)
    other = launch._replace(tiles=launch.tiles + 1)
    for bad in (None, tuple(launch), other):
        with pytest.raises(ValueError):
            pool.pool_update(*args, **kw, tiles=tiles, launch=bad)
    before = pool.pool_update.launches
    pool.pool_update(*args, **kw, tiles=tiles, launch=launch)
    assert pool.pool_update.launches == before + 1


def test_pool_wrapper_rejects_what_it_cannot_take(cuda):
    """One 4x4 level through the wrapper launches the traversal kernel over
    that level, with the level's PoolFixedLevel, or raises."""
    part, ops, _ = _pool_case("dna", cuda)
    plan = part._pool_plan(ops, True)
    pool2d = part.clv_flat.view(16, -1)
    table = plan.tables[0]
    args = (pool2d, part.sc_flat, part.pmatrix, table, plan.gl, plan.gr)
    kw = dict(rates=4, states=4, threshold=part.scale_threshold,
              factor=part.scale_factor, launch=plan.launches[0])
    bad = {
        "float64": ((pool2d.double(),) + args[1:], kw),
        "non-contiguous P": (args[:2] + (part.pmatrix.transpose(2, 3),)
                             + args[3:], kw),
        "host table": (args[:3] + (table.cpu(),) + args[4:], kw),
        "int32 table": (args[:3] + (table.int(),) + args[4:], kw),
        "int64 gathers": (args[:4] + (plan.gl.long(), plan.gr), kw),
        "65 states": (args, dict(kw, states=65)),
        "no level launch": (args, dict(kw, launch=None)),
        "another level's launch": (args, dict(kw, launch=plan.launches[1])),
    }
    for name, (a, k) in bad.items():
        with pytest.raises(ValueError):
            pool.pool_update(*a, **k)


# ----------------------------------- per-rate scalers, raw tips, the probe
def _mode_engine(case, device, dtype=torch.float32):
    """A fused engine in one of the kernels' modes: per-rate scalers
    ('rate'), raw tips from set_tip_clv ('raw', every other tip) or both,
    on the 4x4 DNA variant, the runtime-size one (3 rates) or the rows
    kernel (20 states); 600 sites, or 40003 ('wide')."""
    states = 20 if case.startswith("aa") else 4
    rates = 3 if "r3" in case else 4
    sites = 40003 if "wide" in case else 600
    tree = _caterpillar(60) if "cat" in case else random_utree(
        [f"t{i}" for i in range(16)], seed=3)
    headers, seqs = random_alignment(
        tree.tip_count, sites, alphabet=AA_NOISY if states == 20 else "ACGT",
        seed=3)
    by = dict(zip(headers, seqs))
    part = Partition(tree.tip_count, tree.inner_count, states, sites, 1,
                     tree.edge_count, rates, tree.inner_count, device=device,
                     dtype=dtype, rate_scalers="rate" in case)
    for tip in tree.tips():
        part.set_tip_states(tip.clv_index,
                            maps.map_aa if states == 20 else maps.map_nt,
                            by[tip.label])
    if states == 20:
        load_aa_model(part, "lg")
    else:
        part.set_frequencies(0, [0.3, 0.2, 0.2, 0.3])
        part.set_subst_params(0, [1.0, 2.0, 1.0, 1.0, 2.0, 1.0])
    part.set_category_rates(compute_gamma_cats(0.9, rates))
    if "raw" in case:
        rng = np.random.default_rng(7)
        for tip in sorted(tree.tips(), key=lambda t: t.clv_index)[::2]:
            part.set_tip_clv(tip.clv_index, rng.dirichlet(
                np.ones(states), size=sites))
    return part, TreeEngine(part, tree)


MODE_CASES = ["rate_cat", "rate_r3_cat", "raw", "raw_rate_r3_cat",
              "aa_rate_cat", "aa_raw", "aa_raw_rate_r3", "rate_wide",
              "raw_wide", "raw_rate_wide"]


@pytest.mark.parametrize("case", MODE_CASES)
def test_fused_kernels_modes_match_plain_on_card(cuda, case):
    """Kernels 1 and 2 in per-rate and raw-tip modes against their plain
    version: counts equal (per rate), CLVs to 1e-5 of each site's max;
    'bf16' of the rows kernel at the logL level."""
    part, eng = _mode_engine(case, cuda)
    args, kw = _inputs(part, eng)
    kw.update(rate_scalers=part.rate_scalers, tip_clvs=eng._tip_clvs())
    if part.states == 4:   # fused_traversal.cu's plan (FUSED_PLANS)
        _assert_fused_plan(part, kw["n_slots"], (
            "on-chip", 4) if part.rate_cats != 4 else (
            "on-chip", 2 if "wide" in case else 4), eng.fused_splits,
            kw["tip_clvs"] is not None)
    counter = (fused.fused_traversal_rows if part.states >= 16
               else fused.fused_traversal)
    before = counter.launches
    got = fused.fused_traversal(*args, mxu="highest", **kw)
    assert counter.launches == before + 1
    if part.states == 4:
        assert bool(_assert_clusters_equal(args, kw)) == (
            part.rate_cats == 4)
    want = fused.fused_traversal_reference(*args, mxu="highest", **kw)
    torch.cuda.synchronize()
    for g, w in zip(got[2:], want[2:]):
        assert g.shape == w.shape and torch.equal(g, w)
    for g, w in zip(got[:2], want[:2]):
        site_max = w.abs().amax(dim=(0, 1)).clamp(min=1e-30)
        assert float(((g - w).abs() / site_max).max()) <= 1e-5
    if "cat" in case:
        assert int(want[2].max()) > 0
    if part.states >= 16:
        lk = [float(_fused_loglikelihood(*eng._args(), traversal=t,
                                         mxu="bf16", **eng._fused_kw())[0])
              for t in (fused.fused_traversal,
                        fused.fused_traversal_reference)]
        assert abs(lk[0] - lk[1]) / abs(lk[1]) < 1e-4


@pytest.mark.parametrize("states", [4, 20])
def test_level_kernel_per_rate_matches_plain_on_card(cuda, states):
    part, _ = _mode_engine("aa_rate_cat" if states == 20 else "rate_cat",
                           cuda)
    tree = _caterpillar(60)
    ops, br, pidx = create_operations(traverse(tree.vroot))
    part.update_prob_matrices([0] * 4, pidx, br)
    assert part.scale_buffer.dim() == 3
    clv, sc = part.clv.clone(), part.scale_buffer.clone()
    _run_levels(part, ops, levels.level_update)
    got = part.clv.clone(), part.scale_buffer.clone()
    part.clv.copy_(clv)
    part.scale_buffer.copy_(sc)
    _run_levels(part, ops, levels.level_update_reference)
    torch.cuda.synchronize()
    k = part.scale_buffers
    assert torch.equal(got[1][:k], part.scale_buffer[:k])
    assert int(part.scale_buffer[:k].max()) > 0
    want = part.clv[:part.nodes]
    site_max = want.abs().amax(dim=(1, 2), keepdim=True).clamp(min=1e-30)
    assert float(((got[0][:part.nodes] - want).abs() / site_max).max()) \
        <= 1e-5


def test_pool_kernel_per_rate_matches_plain_on_card(cuda):
    tree = _caterpillar(60)
    headers, seqs = simulate_alignment(tree, 400, [0.3, 0.2, 0.2, 0.3],
                                       [1, 2, 1, 1, 2, 1.0], alpha=0.3,
                                       seed=17)
    by = dict(zip(headers, seqs))
    part = Partition(tree.tip_count, tree.inner_count, 4, 400, 1,
                     tree.edge_count, 4, tree.inner_count, device=cuda,
                     site_repeats=True, rate_scalers=True)
    for tip in tree.tips():
        part.set_tip_states(tip.clv_index, maps.map_nt, by[tip.label])
    part.set_frequencies(0, [0.3, 0.2, 0.2, 0.3])
    part.set_subst_params(0, [1, 2, 1, 1, 2, 1.0])
    part.set_category_rates(compute_gamma_cats(0.3, 4))
    ops, br, pidx = create_operations(traverse(tree.vroot))
    part.update_prob_matrices([0] * 4, pidx, br)
    part._pool_plan(ops, True)
    clv, sc = part.clv_flat.clone(), part.sc_flat.clone()
    _run_pool(part, ops)
    got = part.clv_flat.clone(), part.sc_flat.clone()
    part.clv_flat.copy_(clv)
    part.sc_flat.copy_(sc)
    _run_pool(part, ops, pool.pool_update_reference)
    torch.cuda.synchronize()
    lay = part._flat
    k = lay.sc_trash
    assert torch.equal(got[1][:, :k], part.sc_flat[:, :k])
    assert int(part.sc_flat.max()) > 0
    col_max = part.clv_flat.abs().amax(dim=(0, 1), keepdim=True).clamp(
        min=1e-30)
    assert float(((got[0] - part.clv_flat).abs() / col_max).max()) <= 1e-5


@pytest.mark.parametrize("case", ["rate_cat", "raw", "aa_raw_rate_r3"])
def test_mode_engines_on_card_match_cpu_float64(cuda, case):
    _, gpu = _mode_engine(case, cuda)
    _, cpu = _mode_engine(case, "cpu", dtype=torch.float64)
    got, want = gpu.loglikelihood(), cpu.loglikelihood()
    assert abs(got - want) / abs(want) < 5e-5
    (gl, g1, g2), (wl, w1, w2) = gpu.newton_step(), cpu.newton_step()
    assert abs(gl - wl) / abs(wl) < 5e-5
    for g, w in ((g1, w1), (g2, w2)):
        assert abs(g - w) / max(abs(w), 10.0) < 5e-3


@pytest.mark.parametrize("mode", ["f32", "bf16", "split"])
def test_mxu_probe_matches_plain_on_card(cuda, mode):
    from libpll2_tpu_torch.tools import mxu_probe as mp

    for m, k, t in ((80, 80, 512), (20, 20, 96), (128, 240, 64)):
        a, x = mp.make(m, k, t, tiles=3, device=cuda)
        before = mp.probe.launches, mp.pack.launches
        got = mp.probe(a, x, m, 9, mode, tiles=3)
        assert (mp.probe.launches, mp.pack.launches) == (before[0] + 1,
                                                         before[1] + 1)
        want = mp.probe_reference(a, x, m, 9, mode)
        torch.cuda.synchronize()
        # the tensor cores' float32 accumulation rounds toward zero, a bias
        # of ~1e-5 over these sums against the plain version's rounding
        tol = 1e-5 if mode == "f32" else 5e-5
        assert float((got - want).abs().max() / want.abs().max()) < tol


# (m, k, t, iters): t not a multiple of 64 (nor of 4), m = 20, k = 240 and
# 256 (X's fragment of 16 k steps, 'split''s lo part in shared memory), no
# iteration, fewer than the 8 slices
PROBE_EDGE_CASES = [(80, 80, 100, 9), (20, 240, 130, 9), (20, 20, 96, 0),
                    (80, 80, 64, 3), (128, 256, 70, 5), (7, 33, 1, 2)]


@pytest.mark.parametrize("mode", ["f32", "bf16", "split"])
@pytest.mark.parametrize("case", PROBE_EDGE_CASES,
                         ids=[f"{m}x{k}x{t}_i{i}"
                              for m, k, t, i in PROBE_EDGE_CASES])
def test_mxu_probe_edges_on_card(cuda, mode, case):
    from libpll2_tpu_torch.tools import mxu_probe as mp

    m, k, t, iters = case
    a, x = mp.make(m, k, t, tiles=3, device=cuda)
    before = mp.probe.launches, mp.pack.launches
    got = mp.probe(a, x, m, iters, mode, tiles=3)
    assert (mp.probe.launches, mp.pack.launches) == (before[0] + 1,
                                                     before[1] + 1)
    want = mp.probe_reference(a, x, m, iters, mode)
    torch.cuda.synchronize()
    if iters == 0:
        assert torch.equal(got, torch.zeros_like(got))
        return
    tol = 1e-5 if mode == "f32" else 5e-5
    assert float((got - want).abs().max() / want.abs().max()) < tol


@pytest.mark.parametrize("mode", ["f32", "bf16", "split"])
@pytest.mark.parametrize("m,k,t", [(80, 80, 512), (20, 240, 130),
                                   (7, 33, 1)])
def test_mxu_probe_pack_matches_plain_on_card(cuda, mode, m, k, t):
    """csrc/mxu_probe.cu's `pack` writes the bytes of its plain version
    (ops/_kernels.py:probe_packed) on the same input, every byte."""
    from libpll2_tpu_torch.tools import mxu_probe as mp

    a, _ = mp.make(m, k, t, tiles=1, device=cuda)
    before = mp.pack.launches
    got = mp.pack(a, m, mode, t)
    assert mp.pack.launches == before + 1
    plan = _kernels.probe_plan(m, k, t, 1, mode)
    assert torch.equal(got, _kernels.probe_packed(a, m, 8, plan, mode))


@pytest.mark.parametrize("mode", ["f32", "bf16", "split"])
def test_mxu_probe_refused_plan_raises(cuda, mode, monkeypatch):
    """Both C entries (pll_mxu_probe_pack, pll_mxu_probe) recompute
    ops/_kernels.py:probe_plan and refuse a launch laid out otherwise;
    the wrappers raise and launch nothing."""
    from libpll2_tpu_torch.tools import mxu_probe as mp

    a, x = mp.make(80, 80, 128, tiles=2, device=cuda)
    packed = _kernels.launch_mxu_probe_pack(a, 80, mode, 8, 64)
    plan = _kernels.probe_plan
    for field in ("stages", "cols", "smem_bytes"):
        monkeypatch.setattr(_kernels, "probe_plan", lambda *args, f=field: (
            plan(*args)._replace(**{f: getattr(plan(*args), f) + 8})))
        with pytest.raises(RuntimeError, match="refused"):
            _kernels.launch_mxu_probe_pack(a, 80, mode, 8, 64)
        with pytest.raises(RuntimeError, match="refused"):
            _kernels.launch_mxu_probe(x, packed, 80, 3, mode, 8, 2)
    monkeypatch.setattr(_kernels, "probe_plan", plan)
    got = mp.probe(a, x, 80, 3, mode, tiles=2)
    want = mp.probe_reference(a, x, 80, 3, mode)
    tol = 1e-5 if mode == "f32" else 5e-5
    assert float((got - want).abs().max() / want.abs().max()) < tol


# ------------------------------------------------------- candidate scoring
def _at_neighbours(tree, k, fn):
    """fn() at k NNI neighbours of `tree` (cycled), each move rolled
    back."""
    from libpll2_tpu_torch.trees import moves

    out, nbrs = [], moves.nni_neighbours(tree)
    for i in range(k):
        h, move = nbrs[i % len(nbrs)]
        rb = moves.Rollback()
        moves.nni(h, move, rb)
        out.append(fn())
        moves.rollback_move(rb)
    return out


def _candidate_objects(tree, k):
    """k NNI neighbours as (operations, branches, pmatrix_indices, root
    5-tuple)."""
    def snapshot():
        ops, br, pidx = create_operations(traverse(tree.vroot))
        vr = tree.vroot
        return (ops, br, pidx, (vr.clv_index, vr.scaler_index,
                                vr.back.clv_index, vr.back.scaler_index,
                                vr.pmatrix_index))

    return _at_neighbours(tree, k, snapshot)


def _candidate_inputs(part, eng, tree, k):
    """The candidate form's operands for k NNI neighbours: (tip codes, P
    [k, E, R, s, s], tables [k, n_ops+1, 8]) on the card, and the keywords
    with the largest slot count."""
    packed = _at_neighbours(tree, k, lambda: eng.pack_candidate(tree.vroot))
    dev = part.device
    tables = torch.as_tensor(np.stack([p[0] for p in packed]), device=dev)
    blens = torch.as_tensor(np.stack([p[1] for p in packed]),
                            dtype=torch.float32, device=dev)
    m = eng._model_args()
    pm = update_prob_matrices(m[0], m[1], m[2], m[3], m[4], m[7],
                              blens.reshape(-1))
    pm = pm.view(k, -1, *pm.shape[1:])
    kw = dict(rates=part.rate_cats, states=part.states,
              n_slots=max(p[3] for p in packed),
              threshold=part.scale_threshold, factor=part.scale_factor,
              rate_scalers=part.rate_scalers, tip_clvs=eng._tip_clvs())
    return (eng._tip_codes(), pm, tables), kw


# (engine, candidates, slots forced, the plan: fused_traversal.cu's
# (plan, threads a site) or the rows kernel's (plan, sites a thread)); the
# engines are those of the one-topology cases ('ragged' and 'rates3' of
# `_engine` at 1000 sites, 'aa' its 20 states, `_protein_case`'s spill
# shape and `_mode_engine`'s modes at 600 sites); a launch's blocks count
# over all K candidates (ops/_kernels.py:fused_plan, rows_plan)
CANDIDATE_CASES = {
    "k1": ("ragged", 1, None, ("on-chip", 4)),
    "k3_onchip_spt1": ("ragged", 3, None, ("on-chip", 4)),
    "k130_onchip_spt2": ("ragged", 130, None, ("on-chip", 2)),
    "k3_spill": ("ragged", 3, FUSED_SPILL_SLOTS, ("spill", 1)),
    "k3_rates3": ("rates3", 3, None, ("on-chip", 4)),
    "k3_rates3_spill": ("rates3", 3, GENERIC_SPILL_SLOTS, ("spill", 4)),
    "k3_per_rate": ("rate_cat", 3, None, ("on-chip", 4)),
    "k3_raw": ("raw", 3, None, ("on-chip", 4)),
    "k130_raw_per_rate": ("raw_rate", 130, None, ("on-chip", 2)),
    "aa_k1": ("aa", 1, None, ("on-chip", 1)),
    "aa_k3": ("aa", 3, None, ("on-chip", 1)),
    "aa_k130": ("aa", 130, None, ("on-chip", 2)),
    "aa_k3_spill": ("rates16_states32", 3, None, ("spill", 1)),
    "aa_k3_raw_per_rate": ("aa_raw_rate_r3", 3, None, ("on-chip", 1)),
}


def _candidate_engine(name, device):
    """(partition, engine, tree) of a candidate case's engine."""
    tree = _caterpillar(60) if "cat" in name else random_utree(
        [f"t{i}" for i in range(16)], seed=3)
    if name in ("ragged", "rates3"):
        return (*_engine(tree, 1000, device,
                         rates=3 if name == "rates3" else 4), tree)
    if name == "aa":
        return (*_engine(tree, 1000, device, states=20, alphabet=AA_NOISY),
                tree)
    if name == "rates16_states32":
        return (*_protein_case(name, device), tree)
    return (*_mode_engine(name, device), tree)


@pytest.mark.parametrize("case", sorted(CANDIDATE_CASES))
def test_candidate_kernel_matches_plain_on_card(cuda, case):
    """The candidate form of kernels 1 and 2: K topologies in ONE launch,
    each held against the plain version's walk of that candidate (counts
    equal, CLVs to 1e-5 of each site's max; 'bf16' at the logL level in
    `test_evaluate_topologies_on_card`), on every plan."""
    name, k, slots, want_plan = CANDIDATE_CASES[case]
    part, eng, tree = _candidate_engine(name, cuda)
    args, kw = _candidate_inputs(part, eng, tree, k)
    if slots is not None:
        kw["n_slots"] = slots
    rows = part.states >= fused.ROWS_STATES_MIN
    if rows:
        plan = _kernels.device_rows_plan(cuda, part.rate_cats, part.states,
                                         kw["n_slots"], part.rate_scalers,
                                         part.sites_padded, k)
        assert (plan.plan, plan.sites_per_thread) == want_plan
    else:
        plan = _kernels.device_fused_plan(
            cuda, part.rate_cats, part.states, kw["n_slots"],
            part.rate_scalers, part.sites_padded, k,
            kw.get("tip_clvs") is not None, fused.FusedSplits(args[2].cpu().numpy()))
        assert (plan.plan, plan.threads_per_site) == want_plan
        assert getattr(plan, "cluster", 1) == 1
    counter = fused.fused_traversal_rows if rows else fused.fused_traversal
    before = counter.launches
    got = fused.fused_traversal(*args, mxu="highest", **kw)
    assert counter.launches == before + 1
    if not rows:
        assert bool(_assert_clusters_equal(args, kw)) == (
            want_plan[0] == "on-chip" and part.rate_cats == 4)
    want = fused.fused_traversal_reference(*args, mxu="highest", **kw)
    torch.cuda.synchronize()
    assert got[0].shape[0] == k
    for g, w in zip(got[2:], want[2:]):
        assert g.shape == w.shape and torch.equal(g, w)
    for g, w in zip(got[:2], want[:2]):
        site_max = w.abs().amax(dim=(1, 2)).clamp(min=1e-30)
        err = (g - w).abs() / site_max[:, None, None]
        assert float(err.max()) <= 1e-5
    if "cat" in name:
        assert int(want[2].max()) > 0


@pytest.mark.parametrize("case", ["dna", "protein_split", "protein_bf16",
                                  "repeats_dense_fused"])
def test_evaluate_topologies_on_card(cuda, case):
    """130 candidates (two chunks, two launches) against the float64 CPU
    engine's scores (TOL_LOGL 5e-5; in 'bf16' against its own plain version
    on the card, 1e-4) and the card's own set_topology + loglikelihood() of
    a few of them; evaluate_packed and evaluate_packed_arrays score the
    same."""
    tree = random_utree([f"t{i}" for i in range(24)], seed=5)
    mxu = "bf16" if case.endswith("bf16") else "split"
    engines = []
    for device, dtype in ((cuda, torch.float32), ("cpu", torch.float64)):
        if case == "repeats_dense_fused":
            part = _repeats_partition(copy.deepcopy(tree), 3000, device,
                                      dtype=dtype)
        else:
            states = 4 if case == "dna" else 20
            part = _engine(tree, 3000, device, dtype=dtype, states=states,
                           alphabet=AA_NOISY if states == 20
                           else "ACGT-NRY")[0]
        engines.append(TreeEngine(part, tree, mxu=mxu))
    gpu, cpu = engines
    k = 130
    cands = _candidate_objects(tree, k)
    counter = (fused.fused_traversal_rows if gpu.partition.states >= 16
               else fused.fused_traversal)
    before = counter.launches
    got = gpu.evaluate_topologies(cands)
    assert counter.launches == before + 2
    assert got.shape == (k,)
    if mxu == "bf16":
        from libpll2_tpu_torch.engine import _fused_multi_topology

        m, (pw, inv) = gpu._model_args(), gpu._site_args()
        p = gpu.partition
        packed = _at_neighbours(tree, 4,
                                lambda: gpu.pack_candidate(tree.vroot))
        args = (*m, torch.as_tensor(np.stack([q[1] for q in packed]),
                                    dtype=torch.float32, device=cuda),
                torch.as_tensor(np.stack([q[0] for q in packed]),
                                device=cuda),
                gpu._tip_codes(),
                torch.as_tensor([q[2][4] for q in packed], device=cuda),
                pw, inv, max(q[3] for q in packed), p.scale_threshold,
                p.scale_factor)
        lk = [_fused_multi_topology(*args, traversal=t, mxu=mxu,
                                    **gpu._fused_kw()).cpu().numpy()
              for t in (fused.fused_traversal,
                        fused.fused_traversal_reference)]
        assert float(np.max(np.abs(lk[0] - lk[1]) / np.abs(lk[1]))) < 1e-4
        np.testing.assert_allclose(lk[0], got[:4], rtol=1e-6)
    else:
        want = cpu.evaluate_topologies(cands)
        assert float(np.max(np.abs(got - want) / np.abs(want))) < 5e-5
    one = TreeEngine(gpu.partition, tree, mxu=mxu)
    singles = _at_neighbours(tree, 3, lambda: (one.set_topology(tree),
                                               one.loglikelihood())[1])
    assert float(np.max(np.abs(got[:3] - singles) / np.abs(got[:3]))) < 5e-5
    if case != "repeats_dense_fused":
        packed = _at_neighbours(tree, k,
                                lambda: gpu.pack_candidate(tree.vroot))
        np.testing.assert_allclose(gpu.evaluate_packed(packed), got,
                                   rtol=1e-6)
        tables, blens, roots, slots = zip(*packed)
        np.testing.assert_allclose(gpu.evaluate_packed_arrays(
            np.stack(tables), np.stack(blens), np.asarray(roots),
            max(slots)), got, rtol=1e-6)


# -------------------------------------------------------- topology search
def _search_schedule(part, tree, radius=4):
    """An SPR round's schedule (the native builder) on `part`'s buffers,
    and the P-matrices [E + merged] its passes index."""
    from libpll2_tpu_torch.ops import spr_stream
    from libpll2_tpu_torch.search import TreeSearch

    sched = spr_stream.build_spr_stream_native(
        tree, radius, TreeSearch._n_rows(part), part.scale_buffers,
        part.prob_matrices)
    assert sched is not None
    m = TreeEngine(part, tree)._model_args()

    def pm(lengths):
        return update_prob_matrices(m[0], m[1], m[2], m[3], m[4], m[7],
                                    torch.as_tensor(lengths,
                                                    device=part.device))

    return sched, torch.cat([pm(sched.blen_full), pm(sched.merged_len)])


@pytest.mark.parametrize("states,rate_scalers", [(4, False), (4, True),
                                                 (20, False), (20, True)])
def test_stream_passes_match_plain_on_card(cuda, states, rate_scalers):
    """The streamed rounds' three passes (post, up, A; ops/spr_stream.py)
    through the level kernel, then each level table again through its
    plain version from the kernel's rows of the waves before it: scaler
    rows equal, CLV rows to 1e-5 of each site's max, the zero row
    untouched; the 4x4 and the runtime-size variants, per site and per
    rate."""
    from libpll2_tpu_torch.ops import spr_stream

    tree = random_utree([f"t{i}" for i in range(24)], seed=5)
    part, _ = _engine(tree, 2000 if states == 4 else 600, cuda,
                      states=states, alphabet="ACGT" if states == 4
                      else AA_NOISY[:20], rate_scalers=rate_scalers)
    sched, pm = _search_schedule(part, tree)
    n0 = levels.level_update.launches
    got = spr_stream.stream_passes(
        part.clv, part.scale_buffer, pm,
        [(sched.post_table, sched.post_valid),
         (sched.up_table, sched.up_valid), (sched.a_table, sched.a_valid)],
        sched.n_aux, sched.n_arows, part.scale_threshold, part.scale_factor,
        rate_scalers=rate_scalers)
    assert levels.level_update.launches - n0 == len(got.tables) > 10
    assert not got.scaler[got.zero].any()
    n, R, s, S = got.clv.shape
    clv2d = got.clv.view(n, R * s, S)
    scaled = 0
    for t in got.tables:
        tl = t.long()
        parent, psc = tl[0], tl[7][tl[8] > 0]
        k_clv, k_sc = got.clv[parent], got.scaler[psc]
        levels.level_update_reference(clv2d, got.scaler, pm, t, R, s,
                                      part.scale_threshold,
                                      part.scale_factor)
        w_clv = got.clv[parent]
        assert torch.equal(k_sc, got.scaler[psc])
        site_max = w_clv.abs().amax(dim=(1, 2), keepdim=True).clamp(
            min=1e-30)
        assert float(((k_clv - w_clv).abs() / site_max).max()) <= 1e-5
        scaled = max(scaled, int(k_sc.max()) if k_sc.numel() else 0)
        got.clv[parent] = k_clv
    assert scaled > 0 or states == 20


def test_streamed_round_matches_batched_on_card(cuda):
    """spr_round_streamed (its passes on the level kernel) against
    spr_round_batched (the native builder and the fused kernel's candidate
    form) from the same start at 16 taxa x 96 sites, float32: the same
    moves, the same logL within 5e-5; the native builders loaded."""
    from libpll2_tpu_torch import native
    from libpll2_tpu_torch.search import TreeSearch

    assert native.load() is not None
    out = []
    for kind in ("streamed", "batched"):
        tree = random_utree([f"t{i}" for i in range(16)], seed=11)
        part, _ = _engine(tree, 96, cuda, alphabet="ACGT", seed=11)
        n0 = (levels.level_update.launches, fused.fused_traversal.launches)
        out.append(getattr(TreeSearch(part, tree),
                           f"spr_round_{kind}")(radius=4))
        used = (levels.level_update.launches - n0[0],
                fused.fused_traversal.launches - n0[1])
        assert used[0 if kind == "streamed" else 1] > 0
    assert out[0][1] == out[1][1] >= 1
    assert abs(out[0][0] - out[1][0]) / abs(out[1][0]) < 5e-5


@pytest.mark.parametrize("states", [4, 20])
def test_trial_form_matches_plain_on_card(cuda, states):
    """make_fused_loglikelihood_fn's trials (2n+1 of one maximize_fused
    step) through the fused kernels' candidate form (one launch, the op
    table repeated, each trial its own P-matrices) against the same trials
    through the plain traversal, and against each trial's model set on the
    partition and loglikelihood(): 5e-5 relative; maximize_fused rises by
    one launch a step."""
    from libpll2_tpu_torch.optimize import (make_fused_loglikelihood_fn,
                                            maximize_fused)

    tree = random_utree([f"t{i}" for i in range(20)], seed=7)
    part, eng = _engine(tree, 3000 if states == 4 else 500, cuda,
                        states=states, alphabet="ACGT" if states == 4
                        else AA_NOISY[:20])
    groups = ("subst", "freqs") if states == 4 else ("freqs",)
    fnb, x0, unravel = make_fused_loglikelihood_fn(eng, groups)
    eye = torch.eye(x0.numel(), device=cuda) * 0.02
    X = torch.cat([x0[None], x0[None] + eye, x0[None] - eye])
    counter = fused.fused_traversal if states == 4 else \
        fused.fused_traversal_rows
    n0 = counter.launches
    got = fnb(X).double()
    assert counter.launches - n0 == 1
    orig = eng._trial_loglikelihoods
    eng._trial_loglikelihoods = lambda e, f: orig(
        e, f, traversal=fused.fused_traversal_reference)
    want = fnb(X).double()
    del eng._trial_loglikelihoods
    assert float(((got - want).abs() / want.abs()).max()) < 5e-5
    # row 1: the first parameter up a step, through the partition's setters
    p1 = unravel(X[1])
    f = torch.softmax(p1["freq_logits"].double(), -1)[0].cpu().numpy()
    part.set_frequencies(0, f)
    if "log_subst" in p1:
        part.set_subst_params(0, np.append(
            np.exp(p1["log_subst"][0].double().cpu().numpy()), 1.0))
    assert abs(eng.loglikelihood() - float(got[1])) / abs(float(got[1])) \
        < 5e-5
    n0 = counter.launches
    _, _, hist = maximize_fused(eng, groups, steps=3, chunk=3)
    assert counter.launches - n0 == len(hist) + 1


def test_sweep_step_matches_plain_on_card(cuda):
    """newton_smooth_all's sweep: each step's CLV op is one launch of the
    level kernel (passes x steps + (passes + 1) x refresh levels); one pass
    through the kernel against one through the plain version: branches to
    1e-4 relative, CLV rows to 1e-5 of each site's max, scaler rows equal;
    the result against the float64 sweep on the CPU within 5e-5."""
    from libpll2_tpu_torch.ops import branch_sweep
    from libpll2_tpu_torch.optimize import _sweep_inputs, newton_smooth_all

    tree = random_utree([f"t{i}" for i in range(24)], seed=5)
    part, eng = _engine(tree, 2000, cuda, alphabet="ACGT", seed=5)
    args, kw = _sweep_inputs(eng, tree)
    n0 = levels.level_update.launches
    got = branch_sweep.newton_sweep(*args, passes=1, **kw)
    n_steps, n_levels = len(args[13]), len(args[12])
    assert levels.level_update.launches - n0 == n_steps + 2 * n_levels
    want = branch_sweep.newton_sweep(
        *args, passes=1, level=levels.level_update_reference, **kw)
    assert float(((got[0] - want[0]).abs() / want[0].abs()).max()) <= 1e-4
    assert torch.equal(got[3], want[3])
    site_max = want[2].abs().amax(dim=(1, 2), keepdim=True).clamp(min=1e-30)
    assert float(((got[2] - want[2]).abs() / site_max).max()) <= 1e-5
    cpu_tree = copy.deepcopy(tree)
    cpu_part, cpu_eng = _engine(cpu_tree, 2000, "cpu", dtype=torch.float64,
                                alphabet="ACGT", seed=5)
    lk = newton_smooth_all(eng, tree, passes=2)
    ref = newton_smooth_all(cpu_eng, cpu_tree, passes=2)
    assert abs(lk - ref) / abs(ref) < 5e-5


def _fitch_problem(device, n=40, sites=500, seed=12):
    from libpll2_tpu_torch.parsimony import FastParsimony

    tree = random_utree([f"t{i}" for i in range(n)], seed=seed)
    headers, seqs = simulate_alignment(tree, sites, [0.3, 0.2, 0.2, 0.3],
                                       [1, 2, 1, 1, 2, 1], alpha=0.8,
                                       seed=seed)
    part = Partition(n, n - 2, 4, sites, 1, 2 * n - 3, 1, n - 2,
                     device=device)
    part.set_tip_states_batch(maps.map_nt, seqs)
    return tree, headers, FastParsimony(part)


def test_fitch_on_card_equals_cpu(cuda):
    """Fitch vectors and node costs over a tree's ops, edge scores and one
    tip's insertion scores over every edge on the card `==` the CPU's; the
    stepwise Python loop with Fitch on the card `==` the native build."""
    from libpll2_tpu_torch.parsimony.stepwise import fastparsimony_stepwise
    from libpll2_tpu_torch.trees import export_newick
    from libpll2_tpu_torch.trees.utree import create_pars_buildops

    tree, headers, on_card = _fitch_problem(cuda)
    _, _, on_cpu = _fitch_problem("cpu")
    assert on_card.vectors.device.type == "cuda"
    ops = create_pars_buildops(traverse(tree.vroot))
    for fp in (on_card, on_cpu):
        fp.update_vectors(ops)
    assert torch.equal(on_card.vectors.cpu(), on_cpu.vectors)
    assert torch.equal(on_card.node_cost.cpu(), on_cpu.node_cost)
    trav = traverse(tree.vroot)
    e1 = np.array([h.node_index for h in trav if h.back is not None])
    e2 = np.array([h.back.node_index for h in trav if h.back is not None])
    card, host = ((fp.edge_score(tree.vroot.node_index,
                                 tree.vroot.back.node_index),
                   fp.batch_insert_scores(3, e1, e2))
                  for fp in (on_card, on_cpu))
    assert card[0] == host[0]
    np.testing.assert_array_equal(card[1], host[1])
    nat = fastparsimony_stepwise([on_card], headers, 7)
    loop = fastparsimony_stepwise([on_card], headers, 7, use_native=False)
    assert nat[1] == loop[1]
    assert export_newick(nat[0].vroot) == export_newick(loop[0].vroot)


def test_native_classer_on_card_resident_repeats(cuda):
    """A repeats partition on the card: the native classer's classes of
    every tip and op `==` numpy's, and its 'pool-pallas' logL equals the
    same partition's on the CPU in float32 to 1e-5."""
    from libpll2_tpu_torch import native
    from libpll2_tpu_torch.repeats import _first_occurrence_classes

    assert native.load() is not None
    tree = random_utree([f"t{i}" for i in range(48)], seed=4)
    for nd in tree.nodes():
        for h in ([nd] if nd.is_tip() else list(nd.ring())):
            if h.back is not None:
                h.length = 0.02
    headers, seqs = simulate_alignment(tree, 900, [0.25] * 4,
                                       [1, 2, 1, 1, 2, 1], alpha=0.7,
                                       seed=4)
    by = dict(zip(headers, seqs))
    lk = []
    for device in (cuda, "cpu"):
        part = Partition(48, 46, 4, 900, 1, 93, 4, 46, device=device,
                         site_repeats=True)
        tips = list(tree.tips())
        part.set_tip_states_batch(maps.map_nt, [by[t.label] for t in tips],
                                  [t.clv_index for t in tips])
        part.set_frequencies(0, [0.25] * 4)
        part.set_subst_params(0, [1, 2, 1, 1, 2, 1])
        part.set_category_rates(compute_gamma_cats(0.7, 4))
        eng = TreeEngine(part, tree, pallas="pool")
        lk.append(eng.loglikelihood())
        if device != "cpu":
            table = part.repeats
            for t in range(48):
                sid, isite, ids = _first_occurrence_classes(
                    part.tip_states[t, :900])
                assert int(table.ids[t]) == ids
                assert np.array_equal(table.site_id[t], sid)
            ops = create_operations(traverse(tree.vroot))[0]
            classed = 0
            for op in ops:
                p, l, r = (op.parent_clv_index, op.child1_clv_index,
                           op.child2_clv_index)
                if not table.enable_for(l, r):
                    continue
                sid, isite, ids = _first_occurrence_classes(
                    table.site_id[l].astype(np.int64)
                    + table.site_id[r].astype(np.int64)
                    * int(table.ids[l]))
                if ids < 900:
                    classed += 1
                    assert int(table.ids[p]) == ids
                    assert np.array_equal(table.site_id[p], sid)
                    assert np.array_equal(table.id_site[p, :ids], isite)
            assert classed > 10
    assert lk[0] == pytest.approx(lk[1], rel=1e-5)


# --------------------------------------------- placement: the query form
def _placement_problem(states, n, sites, device, seed=7, caterpillar=False,
                       dtype=torch.float32, rates=4):
    """An EdgePlacer over `n` taxa minus one (t1 pruned), DNA under GTR+G
    or 20 states under LG+G (`rates` categories, 4 by default), and query
    sequences: the pruned taxon and
    mutated, gappy copies of reference rows. The caterpillar's alignment is
    random (unrelated rows), so that sites rescale. Returns (placer,
    queries)."""
    from libpll2_tpu_torch import EdgePlacer
    from libpll2_tpu_torch.trees import export_newick, prune_tip

    freqs = [1 / states] * states
    subst = [1.0] * (states * (states - 1) // 2)
    if caterpillar:
        full = _caterpillar(n)
        headers, seqs = random_alignment(
            n, sites, alphabet="ACGT" if states == 4 else AA_NOISY[:20],
            seed=seed)
    else:
        full = random_utree([f"t{i}" for i in range(n)], seed=seed)
        headers, seqs = simulate_alignment(full, sites, freqs, subst,
                                           alpha=0.8, seed=seed)
    by = dict(zip(headers, seqs))
    a = prune_tip(full, "t1")
    ref = parse_newick(export_newick(a if not a.is_tip() else a.back))
    ref_by = {k: v for k, v in by.items() if k != "t1"}
    placer = EdgePlacer(ref, ref_by, states=states, rate_cats=rates,
                        device=device, dtype=dtype)
    if states == 4:
        placer.set_model([0.3, 0.2, 0.2, 0.3], [1, 2.5, 0.8, 1.1, 2.5, 1],
                         alpha=0.8)
    else:
        load_aa_model(placer.partition, "lg")
        placer.partition.set_category_rates(compute_gamma_cats(0.8, rates))
        placer._engine = placer._stream = None
    rng = np.random.default_rng(seed)
    alphabet = "ACGT" if states == 4 else "ARNDCQEGHILKMFPSTWYV"
    queries = {"t1": by["t1"]}
    for i, lab in enumerate(sorted(ref_by)[:40]):
        s = np.array(list(ref_by[lab]))
        hit = rng.random(sites) < 0.05
        s[hit] = rng.choice(list(alphabet), int(hit.sum()))
        gap = rng.random(sites) < 0.2
        s[gap] = "-"
        queries[f"q{i}"] = "".join(s)
    return placer, queries


def _query_inputs(placer, queries, q, n_edges):
    """The query form's operands: the shared tip codes, the first
    `n_edges` candidates' P [E, B, R, s, s] and tables, the first `q`
    queries' codes; and its keywords."""
    from libpll2_tpu_torch.engine import _pmatrices

    eng = placer._ensure_engine()
    tables, blens, _, n_slots = placer._fused_batch_inputs()
    assert n_edges <= tables.shape[0]
    m = eng._model_args()
    pm = _pmatrices(*m[:5], m[7], blens[:n_edges].reshape(-1))
    pm = pm.view(n_edges, -1, *pm.shape[1:])
    seqs = [queries[k] for k in list(queries)[:q]]
    codes = torch.as_tensor(placer._query_codes_batch(seqs).astype(np.int32),
                            device=placer.partition.device)
    p = placer.partition
    kw = dict(rates=p.rate_cats, states=p.states, n_slots=n_slots,
              threshold=p.scale_threshold, factor=p.scale_factor,
              query_codes=codes, query_row=placer.query_row)
    return (eng._tip_codes(), pm, tables[:n_edges].contiguous()), kw


# (states, taxa, sites, caterpillar, queries, edges, per-rate counts,
# mxu): Q = 1, 3 and 17, up to 130 edges; the caterpillar rescales
QUERY_CASES = {
    "dna_q1": (4, 40, 1000, False, 1, 75, False, "split"),
    "dna_q3_per_rate": (4, 40, 1000, False, 3, 75, True, "split"),
    "dna_q17_e130": (4, 68, 600, True, 17, 130, False, "split"),
    "dna_q3_per_rate_e130": (4, 68, 600, True, 3, 130, True, "split"),
    "aa_split_q3": (20, 24, 600, False, 3, 43, False, "split"),
    "aa_bf16_q3": (20, 24, 600, False, 3, 43, False, "bf16"),
    "aa_split_q17_per_rate": (20, 24, 300, False, 17, 43, True, "split"),
    "aa_split_q1_e130": (20, 68, 300, True, 1, 130, False, "split"),
    "dna_q3_spill": (4, 40, 1000, False, 3, 40, False, "split"),
    "dna_q5_spill_per_rate": (4, 68, 600, True, 5, 60, True, "split"),
    "dna_q3_rates3": (4, 40, 1000, False, 3, 75, False, "split"),
    "aa_q3_rates16": (20, 24, 300, False, 3, 43, False, "split"),
}
# the spill plans with Q > 1, each walk's slots at its own offset in
# device memory: (rate categories, slots forced) of the case; 4 x 4 with
# FUSED_SPILL_SLOTS runs fused_traversal.cu's fused_fixed, 3 rates with
# 400 slots (more than one warp's block holds) its fused_generic, and 20
# states x 16 rates the rows kernel's spill plan
QUERY_SPILL = {"dna_q3_spill": (4, FUSED_SPILL_SLOTS),
               "dna_q5_spill_per_rate": (4, FUSED_SPILL_SLOTS),
               "dna_q3_rates3": (3, 400), "aa_q3_rates16": (16, None)}


@pytest.mark.parametrize("case", sorted(QUERY_CASES))
def test_query_form_matches_plain_on_card(cuda, case):
    """The query form of kernels 1 and 2: Q queries x E attachment edges in
    ONE launch (counted in `launches` and `query_launches`), held against
    the plain version's walks on the same inputs: counts equal, CLVs to
    1e-5 of each site's max; 'bf16' at the logL level (1e-4)."""
    from libpll2_tpu_torch.placement import _place_scores

    states, n, sites, cat, q, e, per_rate, mxu = QUERY_CASES[case]
    rates, slots = QUERY_SPILL.get(case, (4, None))
    placer, queries = _placement_problem(states, n, sites, cuda,
                                         caterpillar=cat, rates=rates)
    args, kw = _query_inputs(placer, queries, q, e)
    kw["rate_scalers"] = per_rate
    if slots is not None:
        kw["n_slots"] = slots
    plan = (_kernels.device_rows_plan if states >= 16 else
            _kernels.device_fused_plan)(cuda, rates, states, kw["n_slots"],
                                        per_rate, args[0].shape[1], q * e)
    assert (plan.plan == "spill") == (case in QUERY_SPILL)
    counter = fused.fused_traversal_rows if states >= 16 else \
        fused.fused_traversal
    before = (counter.launches, counter.query_launches)
    if mxu == "bf16":
        eng = placer._engine
        p = placer.partition
        lk = [_place_scores(kw["query_codes"], args[2], args[1],
                            torch.as_tensor(placer._fused_batch_inputs()[2]
                                            [:e, 4], device=cuda),
                            eng._model_args(), eng._site_args(), args[0],
                            placer.query_row, kw["n_slots"],
                            p.scale_threshold, p.scale_factor, traversal=t,
                            mxu=mxu).double()
              for t in (fused.fused_traversal,
                        fused.fused_traversal_reference)]
        assert float(((lk[0] - lk[1]).abs() / lk[1].abs()).max()) < 1e-4
        assert (counter.launches, counter.query_launches) == \
            (before[0] + 1, before[1] + 1)
        return
    got = fused.fused_traversal(*args, mxu="highest", **kw)
    assert (counter.launches, counter.query_launches) == \
        (before[0] + 1, before[1] + 1)
    if states == 4:
        assert getattr(_kernels.device_fused_plan(
            cuda, rates, states, kw["n_slots"], per_rate, args[0].shape[1],
            q * e, False, fused.FusedSplits(args[2].cpu().numpy())),
            "cluster", 1) == 1
        assert bool(_assert_clusters_equal(args, kw)) == (
            rates == 4 and case not in QUERY_SPILL)
    want = fused.fused_traversal_reference(*args, mxu="highest", **kw)
    torch.cuda.synchronize()
    assert got[0].shape[:2] == (q, e)
    for g, w in zip(got[2:], want[2:]):
        assert g.shape == w.shape and torch.equal(g, w)
    for g, w in zip(got[:2], want[:2]):
        site_max = w.abs().amax(dim=(2, 3)).clamp(min=1e-30)
        err = (g - w).abs() / site_max[:, :, None, None]
        assert float(err.max()) <= 1e-5
    if cat:
        assert int(want[2].max()) > 0


def test_place_batch_matches_place_on_card(cuda):
    """EdgePlacer.place_batch (chunks of 8 and a rest of 1, one launch of
    the query form each) against place() per query (TOL_LOGL 5e-5), the
    same with the chunks split along their edges (a budget of 80 walks a
    launch: equal scores), place_stream against place (2e-5), and place
    against the float64 CPU placer (5e-5)."""
    placer, queries = _placement_problem(4, 40, 1000, cuda)
    sub = {k: queries[k] for k in list(queries)[:9]}
    n0 = fused.fused_traversal.query_launches
    batch = placer.place_batch(sub, chunk=8)
    assert fused.fused_traversal.query_launches - n0 == 2
    singles = {k: placer.place(v) for k, v in sub.items()}

    def by_edge(rows):
        return np.array([r["logL"] for r in sorted(rows,
                                                   key=lambda r: r["edge"])])

    for k in sub:
        got, want = by_edge(batch[k]), by_edge(singles[k])
        assert float(np.max(np.abs(got - want) / np.abs(want))) < 5e-5
    walk = 2 * 4 * 1000 * (16 + 1)
    placer._launch_bytes = 8 * 10 * walk
    n0 = fused.fused_traversal.query_launches
    split = placer.place_batch(sub, chunk=8)
    e = len(placer.edges)
    # 10 edges a launch for the chunk of 8, 80 for the rest of 1
    assert fused.fused_traversal.query_launches - n0 == \
        -(-e // 10) + -(-e // 80)
    for k in sub:
        np.testing.assert_allclose(by_edge(split[k]), by_edge(batch[k]),
                                   rtol=1e-6)
    stream = placer.place_stream(sub)
    for k in sub:
        got, want = by_edge(stream[k]), by_edge(singles[k])
        assert float(np.max(np.abs(got - want) / np.abs(want))) < 2e-5
    cpu, _ = _placement_problem(4, 40, 1000, "cpu", dtype=torch.float64)
    want = by_edge(cpu.place(sub["t1"]))
    got = by_edge(singles["t1"])
    assert float(np.max(np.abs(got - want) / np.abs(want))) < 5e-5


def test_partitioned_engine_on_card_matches_single_engines(cuda):
    """A PartitionedEngine of four units on one tree (three DNA partitions
    under their own GTR+G4, one LG+G4 protein partition) against the sum
    of four single engines on the card and the float64 CPU sum (5e-5);
    linked newton_step leaves one root length."""
    tree = random_utree([f"t{i}" for i in range(24)], seed=9)

    def units(device, dtype):
        parts = []
        for k in range(3):
            parts.append(_engine(tree, 700 + 100 * k, device, dtype=dtype,
                                 alphabet="ACGT", seed=20 + k)[0])
        parts.append(_engine(tree, 500, device, dtype=dtype, states=20,
                             alphabet=AA_NOISY, seed=30)[0])
        return parts

    from libpll2_tpu_torch import PartitionedEngine

    parts = units(cuda, torch.float32)
    pe = PartitionedEngine(parts, tree)
    assert all(e.use_fused for e in pe.engines)
    total = pe.loglikelihood()
    singles = sum(TreeEngine(p, tree).loglikelihood() for p in parts)
    assert abs(total - singles) / abs(singles) < 1e-6
    ref = sum(TreeEngine(p, tree).loglikelihood()
              for p in units("cpu", torch.float64))
    assert abs(total - ref) / abs(ref) < 5e-5
    for _ in range(3):
        pe.newton_step()
    lens = {float(e.branches[int(e.root_idx[4])]) for e in pe.engines}
    assert len(lens) == 1


# the float64 walk (csrc/fused_traversal.cu's fused_generic on double, the
# certified evaluation's): name -> (taxa, sites, states, rates, raw tips);
# 'caterpillar' (300 taxa of random columns) rescales in float64's 2^-256
# window; 'wide' reaches 4 warps a block, 'flagship_sites' (the flagship's
# 3581 patterns) 2; 16 rates x 32 states spill with P read through L1
F64_CASES = {"dna": (16, 1000, 4, 4, False), "rates3": (16, 700, 4, 3, False),
             "states5": (16, 700, 5, 4, False),
             "protein": (16, 500, 20, 4, False), "raw": (16, 900, 4, 4, True),
             "caterpillar": (300, 300, 4, 4, False),
             "rates1": (16, 1000, 4, 1, False),
             "rates8": (16, 700, 4, 8, False),
             "states32": (16, 300, 32, 2, False),
             "raw_protein": (16, 400, 20, 4, True),
             "spill_rates16_states32": (16, 300, 32, 16, False),
             "wide": (24, 16384, 4, 4, False),
             "flagship_sites": (24, 3581, 4, 4, False)}
# the float64 walk's plan for each (generic_plan, itemsize 8)
F64_PLANS = {"spill_rates16_states32": "spill"}


@pytest.mark.parametrize("case", sorted(F64_CASES))
def test_float64_walk_matches_plain_on_card(cuda, case):
    """fused_traversal_f64 against its plain version on the same CUDA
    tensors (scaler counts equal, root CLVs to 1e-12 of each site's largest
    entry: both in float64, FMA contraction against PyTorch's order), one
    launch; loglikelihood_df64 on the card against the same evaluation on
    the CPU (1e-12) and the float64 CPU engine (1e-10)."""
    from libpll2_tpu_torch import loglikelihood_df64
    from libpll2_tpu_torch.ops import df64

    taxa, sites, states, rates, raw = F64_CASES[case]
    tree = (_caterpillar(taxa) if case == "caterpillar"
            else random_utree([f"t{i}" for i in range(taxa)], seed=5))
    alphabet = AA_NOISY if states == 20 else (
        "ACGTX-" if states == 5 else "ACGT-NRY" if states == 4
        else LETTERS32[:states] + "-")

    def build(device, dtype):
        part = _engine(tree, sites, device, dtype=dtype, rates=rates,
                       states=states, alphabet=alphabet, seed=5)[0]
        if raw:
            rng = np.random.default_rng(5)
            for tip in list(tree.tips())[::2]:
                rows = rng.dirichlet(np.ones(states), size=sites)
                part.set_tip_clv(tip.clv_index, rows.astype(np.float32)
                                 .astype(np.float64))
        return part

    part = build(cuda, torch.float32)
    ops, branches, pidx = create_operations(traverse(tree.vroot))
    walk = df64.walk_inputs(part, tree, ops, branches, pidx)
    plan = _kernels.device_generic_plan(
        cuda, rates, states, walk["n_slots"], False, sites, itemsize=8,
        raw_tips=raw)
    assert plan.plan == F64_PLANS.get(case, "on-chip")
    if case.startswith(("wide", "flagship")):
        assert plan.warps == (4 if case == "wide" else 2)
    before = fused.fused_traversal_f64.launches
    got = fused.fused_traversal_f64(**walk)
    torch.cuda.synchronize()
    assert fused.fused_traversal_f64.launches == before + 1
    want = fused.fused_traversal_reference(**walk)
    for g, w in zip(got[:2], want[:2]):
        scale = w.abs().amax(dim=(0, 1)).clamp_min(1e-300)
        assert float(((g - w).abs() / scale).max()) < 1e-12
    for g, w in zip(got[2:], want[2:]):
        assert torch.equal(g, w)
    if case == "caterpillar":
        assert int(got[2].max()) > 0
    lk = loglikelihood_df64(part, tree)
    cpu = loglikelihood_df64(build("cpu", torch.float32), tree)
    assert abs(lk - cpu) / abs(cpu) < 1e-12
    ref = TreeEngine(build("cpu", torch.float64), tree).loglikelihood()
    assert abs(lk - ref) / abs(ref) < 1e-10


# site sharding (libpll2_tpu_torch.parallel): MESH_SHARDS shards of the one
# card, each launching the kernels on its own column block
MESH_SHARDS = 4


def _sharded_problem(states, sites, device, n_taxa=24, seed=8):
    """(tree, the partition sharded over MESH_SHARDS shards of `device`,
    the same partition unsharded): random columns (DNA with ambiguity
    codes, or noisy amino acids under LG), GTR+G4 or LG+G4."""
    from libpll2_tpu_torch.parallel import make_mesh

    tree = random_utree([f"t{i}" for i in range(n_taxa)], seed=seed)
    headers, seqs = random_alignment(
        n_taxa, sites, alphabet=AA_NOISY if states == 20 else "ACGT-NRY",
        seed=seed)
    by = dict(zip(headers, seqs))

    def build(mesh=None):
        part = Partition(tree.tip_count, tree.inner_count, states, sites, 1,
                         tree.edge_count, 4, tree.inner_count, device=device,
                         sites_alignment=MESH_SHARDS if mesh else 1,
                         mesh=mesh)
        tips = list(tree.tips())
        part.set_tip_states_batch(maps.map_aa if states == 20
                                  else maps.map_nt,
                                  [by[t.label] for t in tips],
                                  [t.clv_index for t in tips])
        if states == 20:
            load_aa_model(part, "lg")
        else:
            part.set_frequencies(0, [0.3, 0.2, 0.2, 0.3])
            part.set_subst_params(0, [1.0, 2.0, 1.0, 1.0, 2.0, 1.0])
        part.set_category_rates(compute_gamma_cats(0.8, 4))
        return part

    return tree, build(make_mesh(devices=[device] * MESH_SHARDS)), build()


def _assert_shard_columns(eng, ref):
    """Every shard's root rows and scaler counts equal to the unsharded
    engine's columns at the same branch lengths, and its per-site logL
    equal to the likelihood epilogue run on those columns of the unsharded
    rows: the epilogue's cuBLAS contractions over the states may pick
    another algorithm, and so another summation order, at the full width,
    and that alone separates the two runs' per-site values."""
    from libpll2_tpu_torch.ops import likelihood as ops_likelihood

    ref._set_branches(eng.branches)
    _, per1, rows1 = ref._evaluate()
    _, per, rows = eng._shards.evaluate(eng.branches)
    p = ref.partition
    m = ref._model_args()
    pw, inv = ref._site_args()
    lo = 0
    for shard in rows:
        w = shard[0].shape[-1]
        for got, want in zip(shard, rows1):
            assert torch.equal(got, want[..., lo:lo + w])
        cols = [r[..., lo:lo + w].contiguous() for r in rows1]
        sliced = ops_likelihood.edge_loglikelihood(
            *cols, p.pmatrix[ref.root_idx[4]], m[6], m[3], m[5], m[7],
            pw[lo:lo + w], inv[lo:lo + w], p.scale_threshold,
            **dict(p._modes(), col0=lo))[1]
        assert torch.equal(per[lo:lo + w], sliced)
        lo += w


@pytest.mark.parametrize("states,mxu", [(4, "split"), (20, "split"),
                                        (20, "bf16")])
def test_sharded_fused_path_on_card(cuda, states, mxu):
    """The fused kernels (#1 for DNA, #2 for 20 states) once a shard a
    call on 2004 columns over 4 shards of 501 (no kernel grain): launches
    counted, the shards' columns equal the unsharded run's (and their
    per-site logL the epilogue on them), logL and the
    Newton step's d1/d2 within float32 summation order of it."""
    tree, part, ref_part = _sharded_problem(states, 2004, cuda)
    eng, ref = TreeEngine(part, tree, mxu=mxu), TreeEngine(ref_part, tree,
                                                           mxu=mxu)
    assert eng.execution_path == "fused"
    kernel = fused.fused_traversal if states < 16 else \
        fused.fused_traversal_rows
    other = fused.fused_traversal_rows if states < 16 else \
        fused.fused_traversal
    kernel.launches = other.launches = 0
    got = (eng.loglikelihood(),) + eng.newton_step()
    torch.cuda.synchronize()
    assert kernel.launches == 2 * MESH_SHARDS and other.launches == 0
    want = (ref.loglikelihood(),) + ref.newton_step()
    assert abs(got[0] - want[0]) / abs(want[0]) < 1e-6
    assert abs(got[1] - want[1]) / abs(want[1]) < 1e-6
    np.testing.assert_allclose(got[2:], want[2:], rtol=1e-4, atol=1e-3)
    _assert_shard_columns(eng, ref)


def test_sharded_levels_kernel_on_card(cuda):
    """pallas='levels-kernel' on a mesh: one launch of kernel #3 a level a
    shard, logL equal to the unsharded level-kernel engine's within
    float32 summation order."""
    tree, part, ref_part = _sharded_problem(4, 2004, cuda)
    eng = TreeEngine(part, tree, pallas="levels-kernel")
    ref = TreeEngine(ref_part, tree, pallas="levels-kernel")
    n_levels = len(levels.schedule_levels(
        create_operations(traverse(tree.vroot))[0], part.tips))
    levels.level_update.launches = 0
    lk = eng.loglikelihood()
    torch.cuda.synchronize()
    assert levels.level_update.launches == n_levels * MESH_SHARDS
    want = ref.loglikelihood()
    assert abs(lk - want) / abs(want) < 1e-6


@pytest.mark.parametrize("dense_fused", [True, False])
def test_sharded_repeats_engine_on_card(cuda, dense_fused):
    """ShardedRepeatsEngine over 4 shards of the card: kernel #1 on each
    shard's dense tip codes ('repeats-dense-fused') or kernel #5 on its
    class columns (the 4x4 traversal kernel, one launch a traversal a
    shard), launches counted, logL and the Newton step against the
    unsharded repeats partition on the same columns."""
    from libpll2_tpu_torch.parallel import ShardedRepeatsEngine, make_mesh

    tree = random_utree([f"t{i}" for i in range(40)], seed=11)
    seen = set()
    for nd in tree.nodes():
        for h in ([nd] if nd.is_tip() else list(nd.ring())):
            if h.back is not None and id(h) not in seen:
                seen.update((id(h), id(h.back)))
                h.length = h.back.length = h.length * 0.15 + 0.001
    sites, w = 2000, 500
    headers, seqs = simulate_alignment(tree, sites, [0.25] * 4, [1.0] * 6,
                                       alpha=0.8, seed=11)
    by = dict(zip(headers, seqs))

    def build(lo, hi):
        part = Partition(tree.tip_count, tree.inner_count, 4, hi - lo, 1,
                         tree.edge_count, 4, tree.inner_count, device=cuda,
                         site_repeats=True)
        for t in tree.tips():
            part.set_tip_states(t.clv_index, maps.map_nt,
                                by[t.label][lo:hi])
        part.set_frequencies(0, [0.3, 0.25, 0.2, 0.25])
        part.set_subst_params(0, [1.2, 3.0, 0.8, 1.1, 2.6, 1.0])
        part.set_category_rates(compute_gamma_cats(0.8, 4))
        return part

    eng = ShardedRepeatsEngine(
        tree, [build(k * w, (k + 1) * w) for k in range(MESH_SHARDS)],
        make_mesh(devices=[cuda] * MESH_SHARDS), dense_fused=dense_fused)
    ref = TreeEngine(build(0, sites), tree,
                     pallas="auto" if dense_fused else "pool")
    assert eng.execution_path == ref.execution_path == (
        "repeats-dense-fused" if dense_fused else "pool-pallas")
    fused.fused_traversal.launches = pool.pool_update.launches = 0
    got = (eng.loglikelihood(),) + eng.newton_step()
    torch.cuda.synchronize()
    kernel = fused.fused_traversal if dense_fused else pool.pool_update
    assert kernel.launches == 2 * MESH_SHARDS
    want = (ref.loglikelihood(),) + ref.newton_step()
    assert abs(got[0] - want[0]) / abs(want[0]) < 5e-5
    np.testing.assert_allclose(got[1:], want[1:], rtol=5e-3, atol=5e-2)


# ------------------------------------------------- the trial forms (B-3b)
# level-kernel cases of `_level_case` run as K trials of one launch a level
# (each trial's P the case's with its branches scaled): the 4x4 variant's
# flat list of (trial, op, tile) on the 16-taxon tree at 60000 sites (its
# narrow levels K ops wide) and 20000, per rate, the caterpillar that
# rescales, ops without a scaler and a partial traversal whose trial
# buffers start from the partition's inner rows; the runtime-size variant
# at 20 states (wide: two sites a thread) and 32 states x 16 rates
TRIAL_LEVEL_CASES = ["dna_wide", "dna_narrow", "per_rate_dna_wide",
                     "caterpillar", "no_scaler", "partial", "states20_wide",
                     "rates3", "rates16_states32", "states33", "states61",
                     "per_rate_states61", "caterpillar61", "rates3_states61",
                     "rates10_states40"]
TRIAL_POOL_CASES = ["dna", "caterpillar80", "big_grid", "no_scaler",
                    "partial", "war_serial", "dna_levels", "aa20", "rates3",
                    "aa20_per_rate", "states5", "states40", "states61",
                    "states61_per_rate", "states61_rates3",
                    "states40_rates10"]
TRIALS = 5


def _trial_pmatrices(part, k):
    """P [k, E, R, s, s]: trial i's the partition's P-matrices to the power
    i + 1 (its branch lengths times i + 1)."""
    return torch.stack([torch.linalg.matrix_power(part.pmatrix, i + 1)
                        for i in range(k)]).contiguous()


@pytest.mark.parametrize("case", TRIAL_LEVEL_CASES)
def test_level_trial_form_matches_plain_on_card(cuda, case):
    """The level kernel's trial form (one launch a level for all K trials,
    each its own P, rows and scaler rows, the tips read from the
    partition's buffer) against its plain version on the same trial
    buffers: one launch a level, scaler rows equal, parent rows to 1e-5 of
    each site's largest entry. The buffers start as NaN and -7 but for the
    rows `trial_rows` names, which no trial reads before it writes."""
    part, ops, first = _level_case(case, cuda)
    if first is not None:
        _run_levels(part, first, levels.level_update)
    host = levels.pack_pallas_levels(ops, part.tips, part.scale_buffers + 1,
                                     part.scale_buffers)
    tables = levels.tables_to_device(host, cuda)
    base, rows, sc_rows = levels.trial_rows(host, part.tips)
    pmat = _trial_pmatrices(part, TRIALS)
    clv = torch.full((TRIALS, part.clv.shape[0] - base) + part.clv.shape[1:],
                     float("nan"), device=cuda)
    sc = torch.full((TRIALS,) + part.scale_buffer.shape, -7,
                    dtype=torch.int32, device=cuda)
    idx = torch.as_tensor(rows, device=cuda)
    clv[:, idx - base] = part.clv[idx]
    idx = torch.as_tensor(sc_rows, device=cuda)
    sc[:, idx] = part.scale_buffer[idx]
    want_clv, want_sc = clv.clone(), sc.clone()
    args = (part.scale_threshold, part.scale_factor)
    before = levels.level_update.launches
    levels.update_partials_kernel(clv, sc, pmat, tables, *args,
                                  tips=part.clv[:base])
    assert levels.level_update.launches == before + len(tables)
    levels.update_partials_kernel(want_clv, want_sc, pmat, tables, *args,
                                  level=levels.level_update_reference,
                                  tips=part.clv[:base])
    torch.cuda.synchronize()
    parents = torch.as_tensor(sorted({o.parent_clv_index - base
                                      for o in ops}), device=cuda)
    written = torch.as_tensor(sorted(
        {int(t) for tb in host for t in tb[7]} - {part.scale_buffers}),
        device=cuda)
    assert torch.equal(sc[:, written], want_sc[:, written])
    got, want = clv[:, parents], want_clv[:, parents]
    assert bool(torch.isfinite(got).all())
    site_max = want.abs().amax(dim=(2, 3), keepdim=True).clamp(min=1e-30)
    assert float(((got - want).abs() / site_max).max()) <= 1e-5
    if case in ("caterpillar", "caterpillar61"):
        assert int(want_sc[:, written].max()) > 0


@pytest.mark.parametrize("case", TRIAL_POOL_CASES)
def test_pool_trial_form_matches_plain_on_card(cuda, case):
    """The pool kernel's trial form (at 4x4 one launch of the traversal
    kernel for all K trials, its tickets drawn K times, each trial's counts
    its own; else one launch a level, the trial on the grid's y; 'dna_levels'
    the 4x4 kernel a level a launch) against its plain version on the same
    trial pools: scaler regions equal (the trash region aside), the zero
    region zero, class columns to 1e-5 of each column's largest entry."""
    part, ops, first = _pool_case(case, cuda)
    if first is not None:
        _run_pool(part, first)
    plan = part._pool_plan(ops, True)
    pmat = _trial_pmatrices(part, TRIALS)
    pools = part.clv_flat.expand(TRIALS, *part.clv_flat.shape).contiguous()
    sc = part.sc_flat.expand(TRIALS, *part.sc_flat.shape).contiguous()
    want_pools, want_sc = pools.clone(), sc.clone()
    args = (part.scale_threshold, part.scale_factor)
    level = pool.pool_update if case == "dna_levels" else None
    before = pool.pool_update.launches
    pool.update_partials_pool(pools, sc, pmat, plan, *args, level=level)
    n = 1 if level is None and plan.traversal is not None \
        else len(plan.tables)
    assert pool.pool_update.launches == before + n
    pool.update_partials_pool(want_pools, want_sc, pmat, plan, *args,
                              level=pool.pool_update_reference)
    torch.cuda.synchronize()
    lay = part._flat
    assert torch.equal(sc[..., :lay.sc_trash], want_sc[..., :lay.sc_trash])
    assert not bool(sc[..., lay.sc_zero:].any())
    assert bool(torch.isfinite(pools).all())
    col_max = want_pools.abs().amax(dim=(1, 2), keepdim=True).clamp(
        min=1e-30)
    assert float(((pools - want_pools).abs() / col_max).max()) <= 1e-5
    if case == "caterpillar80":
        assert int(want_sc[..., :lay.sc_trash].max()) > 0


@pytest.mark.parametrize("path", ["levels-kernel", "pool-pallas"])
def test_trials_on_card_one_launch_a_level_a_chunk(cuda, path, monkeypatch):
    """make_fused_loglikelihood_fn's 2n+1 trials of one maximize_fused step
    on 'levels-kernel' (16 taxa x 3000 DNA sites) and 'pool-pallas' (24 x
    600 conserved): one level-kernel launch a level (one pool-kernel launch
    a traversal at 4x4) for the chunk, the values within 5e-5 of the same
    trials through the plain version; under a budget of two trials a chunk,
    a launch a level (a traversal) a chunk, and the same values to 1e-6;
    the partition's buffers unchanged."""
    from libpll2_tpu_torch import engine as tengine
    from libpll2_tpu_torch.optimize import make_fused_loglikelihood_fn

    if path == "levels-kernel":
        tree = random_utree([f"t{i}" for i in range(16)], seed=7)
        part, _ = _engine(tree, 3000, cuda, alphabet="ACGT")
        eng = TreeEngine(part, tree, pallas="levels-kernel")
        counter, per_chunk = levels.level_update, len(eng._ops)
        plain = levels.level_update_reference
        bufs = (part.clv, part.scale_buffer)
    else:
        tree = random_utree([f"t{i}" for i in range(24)], seed=11)
        part = _repeats_partition(tree, 600, cuda)
        eng = TreeEngine(part, tree, pallas="pool")
        counter, per_chunk = pool.pool_update, 1
        plain = pool.pool_update_reference
        bufs = (part.clv_flat, part.sc_flat)
    assert eng.execution_path == path
    fnb, x0, _ = make_fused_loglikelihood_fn(eng, ("subst", "freqs"))
    eye = torch.eye(x0.numel(), device=cuda) * 0.02
    X = torch.cat([x0[None], x0[None] + eye, x0[None] - eye])
    before = [b.clone() for b in bufs]
    n0 = counter.launches
    got = fnb(X).double()
    torch.cuda.synchronize()
    assert counter.launches - n0 == per_chunk
    for b, b0 in zip(bufs, before):
        assert torch.equal(b, b0)
    orig = eng._trial_loglikelihoods
    eng._trial_loglikelihoods = lambda e, f: orig(e, f, level=plain)
    want = fnb(X).double()
    del eng._trial_loglikelihoods
    assert float(((got - want).abs() / want.abs()).max()) < 5e-5
    monkeypatch.setattr(tengine, "TRIAL_LAUNCH_BYTES",
                        2 * eng.trial_bytes() + 1)
    n0 = counter.launches
    chunked = fnb(X).double()
    torch.cuda.synchronize()
    chunks = -(-X.shape[0] // 2)
    assert counter.launches - n0 == chunks * per_chunk
    assert float(((chunked - got).abs() / got.abs()).max()) < 1e-6


# ------------------------------------------------------------ the loops
# loglikelihood_loop / newton_loop on the card: the first iteration eager,
# the next captured once in a CUDA graph and replayed (engine.py:
# run_chained), on every route; each case builds the same engine twice,
# one for the loop and one for the eager chain it is held against
LOOP_CASES = ["fused", "fused_r3", "rows_split", "rows_bf16", "levels_4x4",
              "levels_aa", "levels_40", "pool_4x4", "pool_r3", "pool_40",
              "repeats_dense_fused", "f64_levels", "f64_scan", "f64_pool",
              "sharded_fused", "sharded_levels", "sharded_repeats_fused",
              "sharded_repeats_pool"]
LOOP_K = 5


def _loop_engine(case, device):
    """A fresh engine (TreeEngine or ShardedRepeatsEngine) of one loop
    case."""
    from libpll2_tpu_torch.parallel import ShardedRepeatsEngine, make_mesh

    tree = random_utree([f"t{i}" for i in range(16)], seed=3)
    if case.startswith("sharded_repeats"):
        parts = [_repeats_partition(tree, 500, device, seed=11 + k)
                 for k in range(MESH_SHARDS)]
        return ShardedRepeatsEngine(
            tree, parts, make_mesh(devices=[device] * MESH_SHARDS),
            dense_fused=case.endswith("fused"))
    if case.startswith("sharded"):
        tree, part, _ = _sharded_problem(4, 2004, device)
        return TreeEngine(part, tree, pallas="auto" if case.endswith("fused")
                          else "levels-kernel")
    if case.startswith("pool") or case == "repeats_dense_fused":
        kw = {"pool_r3": dict(rates=3), "pool_40": dict(states=40)}
        part = _repeats_partition(tree, 600, device, **kw.get(case, {}))
        return TreeEngine(part, tree, pallas="auto" if case.startswith(
            "repeats") else "pool")
    if case == "f64_pool":
        part = _repeats_partition(tree, 600, device, dtype=torch.float64)
        return TreeEngine(part, tree)
    states = {"rows_split": 20, "rows_bf16": 20, "levels_aa": 20,
              "levels_40": 40}.get(case, 4)
    part, _ = _engine(
        tree, 700, device, states=states,
        rates=3 if case == "fused_r3" else 4,
        dtype=torch.float64 if case.startswith("f64") else torch.float32,
        alphabet=(AA_NOISY if states == 20 else LETTERS64[:states] + "-"
                  if states == 40 else "ACGT-NRY"))
    kw = {"rows_bf16": dict(mxu="bf16"), "f64_scan": dict(
        level_schedule=False), "levels_4x4": dict(pallas="levels-kernel"),
          "levels_aa": dict(pallas="levels-kernel")}
    return TreeEngine(part, tree, **kw.get(case, {}))


def _all_launches():
    return (fused.fused_traversal.launches
            + fused.fused_traversal_rows.launches
            + levels.level_update.launches + pool.pool_update.launches)


@pytest.mark.parametrize("case", LOOP_CASES)
def test_loops_on_card_match_the_eager_chain(cuda, case):
    """loglikelihood_loop(k) against k loglikelihood() calls summed in the
    partition's dtype, and newton_loop(k) against k chained newton_step()s
    (logL, d1, d2 and the branches), each on a twin engine: captured in a
    graph on every route (a 4-shard mesh of the card too), equal within
    float32 summation order (the replays run the eager iteration's
    kernels; the epilogue's cuBLAS calls may take another workspace), and
    the launch counters read k times one evaluation's launches."""
    eng, twin = _loop_engine(case, cuda), _loop_engine(case, cuda)
    n0 = _all_launches()
    acc = None
    for _ in range(LOOP_K):
        total = twin._evaluate()[0].reshape(())
        acc = total.clone() if acc is None else acc + total
    want = float(acc)
    per_eval = (_all_launches() - n0) // LOOP_K
    assert per_eval * LOOP_K == _all_launches() - n0
    assert per_eval > 0 or case.startswith("f64")
    n0 = _all_launches()
    got = eng.loglikelihood_loop(LOOP_K)
    torch.cuda.synchronize()
    assert eng._last_loop.route == "graph"
    assert eng._last_loop.capture_ms is not None
    assert _all_launches() - n0 == LOOP_K * per_eval
    tol = 1e-12 if case.startswith("f64") else 5e-5
    assert abs(got - want) <= tol * abs(want), (got, want)
    assert eng.loglikelihood_loop(0) == 0.0
    want_n = [twin.newton_step() for _ in range(3)][-1]
    got_n = eng.newton_loop(3)
    assert eng._last_loop.route == "graph"
    assert abs(got_n[0] - want_n[0]) <= tol * abs(want_n[0])
    np.testing.assert_allclose(got_n[1:], want_n[1:], rtol=tol * 100,
                               atol=tol * 1e3)
    np.testing.assert_allclose(eng.branches.cpu().numpy(),
                               twin.branches.cpu().numpy(), rtol=tol * 10)
    # the engine goes on after a loop: its buffers are its own
    assert abs(eng.loglikelihood() - twin.loglikelihood()) <= tol * abs(
        want_n[0])


def test_loop_counters_and_buffers_after_a_graph(cuda):
    """After a graph loop on the fused path the partition's P-matrices are
    its own tensor (not the graph pool's), the root rows written back equal
    an eager evaluation's, and k = 0 leaves every buffer as it was."""
    eng = _loop_engine("fused", cuda)
    twin = _loop_engine("fused", cuda)
    eng.loglikelihood()
    p = eng.partition
    before = [t.clone() for t in (p.clv, p.scale_buffer, p.pmatrix,
                                  eng.branches)]
    assert eng.loglikelihood_loop(0) == 0.0
    assert eng.newton_loop(0) == (0.0, 0.0, 0.0)
    for t, b in zip((p.clv, p.scale_buffer, p.pmatrix, eng.branches),
                    before):
        assert torch.equal(t, b)
    fused.fused_traversal.launches = 0
    eng.loglikelihood_loop(7)
    torch.cuda.synchronize()
    assert fused.fused_traversal.launches == 7
    assert eng._last_loop.launches == {"fused_traversal": 1}
    twin.loglikelihood()
    r = eng.root_idx
    for row in (r[0], r[2]):
        torch.testing.assert_close(p.clv[row], twin.partition.clv[row],
                                   rtol=1e-6, atol=0)
    pm = p.pmatrix
    eng.newton_loop(4)
    assert p.pmatrix is not pm and bool(torch.isfinite(p.pmatrix).all())
