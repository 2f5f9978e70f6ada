"""The port's CUDA kernel on the card (marker `gpu`; skips without one).

Run on a machine with an NVIDIA GPU and nvcc, from the repository root:

    python -m pytest --noconftest -o addopts="" -m gpu tests/test_torch_cuda.py

(`--noconftest`: tests/conftest.py imports jax, which that machine need not
have; this file imports only torch and the port.) Each kernel is held
against its plain PyTorch version on the same CUDA tensors: scaler counts
equal, root CLVs to 1e-5 of each site's largest entry (FMA contraction vs
PyTorch's summation order). In the rows kernel's 'bf16' mode both versions
round the same operands to bf16, but a last-bit difference of a float32
sum can round a value to the other bf16 neighbour, so that mode is held at
the logL level, to 1e-4 relative. The level kernel (csrc/level_update.cu)
is held to equal scaler rows and CLV rows to 1e-5 of each site's largest
entry over a whole traversal, level by level; the pool kernel
(csrc/pool_update.cu) to equal scaler regions (the trash region aside,
which ops without a scaler buffer of one level write at once) and class
columns to 1e-5 of each column's largest entry. Their per-rate and raw-tip
modes are held the same way, counts compared per rate; the matrix-unit
probe (csrc/mxu_probe.cu) to 1e-5 of its output's largest entry in 'f32'
(the two versions add the same products in another order) and 5e-5 in
'bf16' and 'split' (the tensor cores' float32 accumulation rounds toward
zero)."""
import numpy as np
import pytest
import torch

from libpll2_tpu_torch import Partition, TreeEngine, compute_gamma_cats
from libpll2_tpu_torch.engine import _fused_loglikelihood
from libpll2_tpu_torch.io import maps
from libpll2_tpu_torch.models import load_aa_model
from libpll2_tpu_torch.ops import fused, levels, pool
from libpll2_tpu_torch.ops.pmatrix import update_prob_matrices
from libpll2_tpu_torch.trees import (create_operations, parse_newick,
                                     random_alignment, random_utree,
                                     traverse)
from libpll2_tpu_torch.utils import simulate_alignment

pytestmark = pytest.mark.gpu

CHARMAP5 = np.zeros(256, np.uint64)
for _i, _ch in enumerate("ACGTX"):
    CHARMAP5[ord(_ch)] = 1 << _i
CHARMAP5[ord("-")] = 31
LETTERS32 = "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdef"
AA_NOISY = "ARNDCQEGHILKMFPSTWYVARNDCQEGHILKMFPSTWYVBZX-"


def _charmap(states):
    """States 0..s-1 as the first s of LETTERS32; '-' is every state."""
    cm = np.zeros(256, np.uint64)
    for i, ch in enumerate(LETTERS32[:states]):
        cm[ord(ch)] = 1 << i
    cm[ord("-")] = (1 << states) - 1
    return cm


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _engine(tree, sites, device, dtype=torch.float32, rates=4, states=4,
            alphabet="ACGT-NRY", seed=3):
    headers, seqs = random_alignment(tree.tip_count, sites,
                                     alphabet=alphabet, seed=seed)
    by = dict(zip(headers, seqs))
    part = Partition(tree.tip_count, tree.inner_count, states, sites, 1,
                     tree.edge_count, rates, tree.inner_count, device=device,
                     dtype=dtype)
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
              factor=part.scale_factor)
    return (eng._tip_codes(), pm, eng.table), kw


def _caterpillar(n):
    text = f"t{n - 1}:0.1"
    for i in range(n - 2, 1, -1):
        text = f"(t{i}:0.1,{text}):0.1"
    return parse_newick(f"(t0:0.1,t1:0.1,{text});")


@pytest.mark.parametrize("case", ["ragged", "rates3", "states5",
                                  "caterpillar"])
def test_kernel_matches_plain_on_card(cuda, case):
    if case == "caterpillar":
        part, eng = _engine(_caterpillar(80), 700, cuda, alphabet="ACGT")
    else:
        tree = random_utree([f"t{i}" for i in range(16)], seed=3)
        kw = {"rates3": dict(rates=3),
              "states5": dict(states=5, alphabet="ACGTX-")}.get(case, {})
        part, eng = _engine(tree, 1000, cuda, **kw)
    args, kw = _inputs(part, eng)
    before = fused.fused_traversal.launches
    got = fused.fused_traversal(*args, **kw)
    assert fused.fused_traversal.launches == before + 1
    want = fused.fused_traversal_reference(*args, **kw)
    torch.cuda.synchronize()
    for g, w in zip(got[2:], want[2:]):
        assert torch.equal(g, w)
    for g, w in zip(got[:2], want[:2]):
        site_max = w.abs().amax(dim=(0, 1)).clamp(min=1e-30)
        assert float(((g - w).abs() / site_max).max()) <= 1e-5
    if case == "caterpillar":
        assert int(want[2].max()) > 0


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


def _protein_case(case, device):
    tree = random_utree([f"t{i}" for i in range(16)], seed=3)
    if case == "caterpillar":
        return _engine(_caterpillar(80), 700, device, states=20,
                       alphabet=AA_NOISY)
    if case == "rates3":
        return _engine(tree, 1000, device, states=20, rates=3,
                       alphabet=AA_NOISY)
    if case in ("states16", "states32"):
        s = int(case[6:])
        return _engine(tree, 1000, device, states=s,
                       alphabet=LETTERS32[:s] + "-")
    return _engine(tree, 1000, device, states=20, alphabet=AA_NOISY)


@pytest.mark.parametrize("mode", ["highest", "bf16"])
@pytest.mark.parametrize("case", ["ragged", "caterpillar", "rates3",
                                  "states16", "states32"])
def test_rows_kernel_matches_plain_on_card(cuda, case, mode):
    part, eng = _protein_case(case, cuda)
    args, kw = _inputs(part, eng)
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
                                         mxu=mode)[0])
              for t in (fused.fused_traversal,
                        fused.fused_traversal_reference)]
        assert abs(lk[0] - lk[1]) / abs(lk[1]) < 1e-4
        return
    for g, w in zip(got[2:], want[2:]):
        assert torch.equal(g, w)
    for g, w in zip(got[:2], want[:2]):
        site_max = w.abs().amax(dim=(0, 1)).clamp(min=1e-30)
        assert float(((g - w).abs() / site_max).max()) <= 1e-5
    # 'split' is the same exact contraction as 'highest'
    for g, w in zip(fused.fused_traversal(*args, mxu="split", **kw), got):
        assert torch.equal(g, w)


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
               "no_scaler", "partial"]


def _level_case(case, device, dtype=torch.float32):
    """(partition with P-matrices set, the op list to run, the full list
    that must run first or None) for one level-kernel case."""
    tree = random_utree([f"t{i}" for i in range(16)], seed=3)
    kw = dict(dtype=dtype)
    if case == "caterpillar":
        tree, kw = _caterpillar(80), dict(kw, alphabet="ACGT")
    elif case == "rates3":
        kw["rates"] = 3
    elif case in ("states20", "states32"):
        s = int(case[6:])
        kw.update(states=s, alphabet=AA_NOISY if s == 20
                  else LETTERS32[:s] + "-")
    part, _ = _engine(tree, 700 if case == "caterpillar" else 1000, device,
                      **kw)
    ops, br, pidx = create_operations(traverse(tree.vroot))
    part.update_prob_matrices([0] * part.rate_cats, pidx, br)
    if case == "no_scaler":
        for op in ops[::3]:
            op.parent_scaler_index = -1
    if case == "partial":
        return part, ops[len(ops) // 2:], ops
    return part, ops, None


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
    if case == "caterpillar":
        assert int(part.scale_buffer[:k].max()) > 0


@pytest.mark.parametrize("states", [4, 20])
def test_levels_kernel_engine_on_card_matches_cpu_float64(cuda, states):
    tree = random_utree([f"t{i}" for i in range(24)], seed=5)
    kw = dict(states=states, alphabet=AA_NOISY) if states == 20 else {}
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
        "33 states": (args, dict(kw, states=33)),
    }
    for name, (a, k) in bad.items():
        with pytest.raises(ValueError):
            levels.level_update(*a, **k)


POOL_CASES = ["dna", "rates3", "aa20", "caterpillar", "partial",
              "no_scaler", "identity"]


def _repeats_partition(tree, sites, device, states=4, rates=4, seed=11,
                       conserved=True, dtype=torch.float32):
    """A site-repeats partition of an alignment simulated on `tree`
    (branches shortened to 0.15 len + 0.001 when `conserved`), or of random
    columns (`conserved` False: repeats switch off at most inner nodes)."""
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
            alpha=0.8, seed=seed)
    else:
        headers, seqs = random_alignment(tree.tip_count, sites, seed=seed)
    by = dict(zip(headers, seqs))
    part = Partition(tree.tip_count, tree.inner_count, states, sites, 1,
                     tree.edge_count, rates, tree.inner_count, device=device,
                     dtype=dtype, site_repeats=True)
    tips = list(tree.tips())
    part.set_tip_states_batch(maps.map_aa if states == 20 else maps.map_nt,
                              [by[t.label] for t in tips],
                              [t.clv_index for t in tips])
    if states == 20:
        load_aa_model(part, "lg")
    else:
        part.set_frequencies(0, [0.3, 0.25, 0.2, 0.25])
        part.set_subst_params(0, [1.2, 3.0, 0.8, 1.1, 2.6, 1.0])
    part.set_category_rates(compute_gamma_cats(0.8, rates))
    return part


def _pool_case(case, device):
    """(repeats partition with P-matrices set, the op list to run, the full
    list that must run first or None) for one pool-kernel case."""
    tree = random_utree([f"t{i}" for i in range(24)], seed=11)
    kw = {"rates3": dict(rates=3), "aa20": dict(states=20)}.get(case, {})
    sites = 600
    if case == "caterpillar":
        tree, sites = _caterpillar(150), 300
    elif case == "identity":
        tree, sites = random_utree([f"t{i}" for i in range(32)], seed=11), \
            2048
        kw = dict(conserved=False)
    part = _repeats_partition(tree, sites, device, **kw)
    ops, br, pidx = create_operations(traverse(tree.vroot))
    part.update_prob_matrices([0] * part.rate_cats, pidx, br)
    if case == "no_scaler":
        for op in ops[::3]:
            op.parent_scaler_index = -1
    if case == "partial":
        return part, ops[len(ops) // 2:], ops
    return part, ops, None


def _run_pool(part, ops, level):
    plan = part._pool_plan(ops, True)
    pool.update_partials_pool(part.clv_flat, part.sc_flat, part.pmatrix,
                              plan, part.scale_threshold, part.scale_factor,
                              level=level)
    return len(plan.tables)


@pytest.mark.parametrize("case", POOL_CASES)
def test_pool_kernel_matches_plain_on_card(cuda, case):
    part, ops, first = _pool_case(case, cuda)
    if first is not None:
        _run_pool(part, first, pool.pool_update)
    part._pool_plan(ops, True)            # lays the pool out, computes none
    clv, sc = part.clv_flat.clone(), part.sc_flat.clone()
    before = pool.pool_update.launches
    n = _run_pool(part, ops, pool.pool_update)
    assert pool.pool_update.launches == before + n
    got_clv, got_sc = part.clv_flat.clone(), part.sc_flat.clone()
    part.clv_flat.copy_(clv)
    part.sc_flat.copy_(sc)
    _run_pool(part, ops, pool.pool_update_reference)
    torch.cuda.synchronize()
    lay = part._flat
    keep = torch.ones_like(got_sc, dtype=torch.bool)
    keep[lay.sc_trash:lay.sc_zero] = False
    assert torch.equal(got_sc[keep], part.sc_flat[keep])
    assert not got_sc[lay.sc_zero:].any()
    want = part.clv_flat
    col_max = want.abs().amax(dim=(0, 1), keepdim=True).clamp(min=1e-30)
    assert float(((got_clv - want).abs() / col_max).max()) <= 1e-5
    if case == "caterpillar":
        assert int(part.sc_flat[:lay.sc_trash].max()) > 0
    if case == "identity":
        assert max(plan_w for plan_w in part._repeat_schedule.widths) == \
            lay.caps.max()


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
        assert pool.pool_update.launches == before + len(gpu._ops.tables)
    assert abs(got - want) / abs(want) < 5e-5
    for _ in range(3):
        (gl, g1, g2), (wl, w1, w2) = gpu.newton_step(), cpu.newton_step()
        assert abs(gl - wl) / abs(wl) < 5e-5
        for g, w in ((g1, w1), (g2, w2)):
            assert abs(g - w) / max(abs(w), 10.0) < 5e-3


def test_pool_wrapper_rejects_what_it_cannot_take(cuda):
    part, ops, _ = _pool_case("dna", cuda)
    plan = part._pool_plan(ops, True)
    pool2d = part.clv_flat.view(16, -1)
    table, width = plan.tables[0], plan.widths[0]
    args = (pool2d, part.sc_flat, part.pmatrix, table, width, plan.gl,
            plan.gr)
    kw = dict(rates=4, states=4, threshold=part.scale_threshold,
              factor=part.scale_factor)
    bad = {
        "float64": ((pool2d.double(),) + args[1:], kw),
        "non-contiguous P": (args[:2] + (part.pmatrix.transpose(2, 3),)
                             + args[3:], kw),
        "host table": (args[:3] + (table.cpu(),) + args[4:], kw),
        "int32 table": (args[:3] + (table.int(),) + args[4:], kw),
        "int64 gathers": (args[:5] + (plan.gl.long(), plan.gr), kw),
        "33 states": (args, dict(kw, states=33)),
        "zero width": (args[:4] + (0,) + args[5:], kw),
    }
    for name, (a, k) in bad.items():
        with pytest.raises(ValueError):
            pool.pool_update(*a, **k)


# ----------------------------------- per-rate scalers, raw tips, the probe
def _mode_engine(case, device, dtype=torch.float32):
    """A fused engine in one of the kernels' modes: per-rate scalers
    ('rate'), raw tips from set_tip_clv ('raw', every other tip) or both,
    on the 4x4 DNA variant, the runtime-size one (3 rates) or the rows
    kernel (20 states)."""
    states = 20 if case.startswith("aa") else 4
    rates = 3 if "r3" in case else 4
    tree = _caterpillar(60) if "cat" in case else random_utree(
        [f"t{i}" for i in range(16)], seed=3)
    headers, seqs = random_alignment(
        tree.tip_count, 600, alphabet=AA_NOISY if states == 20 else "ACGT",
        seed=3)
    by = dict(zip(headers, seqs))
    part = Partition(tree.tip_count, tree.inner_count, states, 600, 1,
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
                np.ones(states), size=600))
    return part, TreeEngine(part, tree)


MODE_CASES = ["rate_cat", "rate_r3_cat", "raw", "raw_rate_r3_cat",
              "aa_rate_cat", "aa_raw", "aa_raw_rate_r3"]


@pytest.mark.parametrize("case", MODE_CASES)
def test_fused_kernels_modes_match_plain_on_card(cuda, case):
    """Kernels 1 and 2 in per-rate and raw-tip modes against their plain
    version: counts equal (per rate), CLVs to 1e-5 of each site's max;
    'bf16' of the rows kernel at the logL level."""
    part, eng = _mode_engine(case, cuda)
    args, kw = _inputs(part, eng)
    kw.update(rate_scalers=part.rate_scalers, tip_clvs=eng._tip_clvs())
    counter = (fused.fused_traversal_rows if part.states >= 16
               else fused.fused_traversal)
    before = counter.launches
    got = fused.fused_traversal(*args, mxu="highest", **kw)
    assert counter.launches == before + 1
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
    _run_pool(part, ops, pool.pool_update)
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
        before = mp.probe.launches
        got = mp.probe(a, x, m, 9, mode, tiles=3)
        assert mp.probe.launches == before + 1
        want = mp.probe_reference(a, x, m, 9, mode)
        torch.cuda.synchronize()
        # the tensor cores' float32 accumulation rounds toward zero, a bias
        # of ~1e-5 over these sums against the plain version's rounding
        tol = 1e-5 if mode == "f32" else 5e-5
        assert float((got - want).abs().max() / want.abs().max()) < tol
