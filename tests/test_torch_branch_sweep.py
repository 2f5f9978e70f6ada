"""All-branches Newton smoothing in the port (`ops/branch_sweep.py`,
`optimize.newton_smooth_all`, `optimize.newton_optimize_branches`)
against libpll2_tpu on the CPU.

Both packages build tests/test_branch_sweep.py's problem (a random tree of
one seed with its lengths perturbed, the alignment simulated once) on their
own trees. Tolerances: the schedule `==` JAX's; float64, the port against
JAX's `pallas=False` engine: branches to 1e-8 relative and logL to 1e-10
(the two differ in summation order only); float32 per-rate with scaling:
logL within TOL_LOGL 5e-5 and branches within 1e-4. Every construction
passes device="cpu": each step's CLV op and every refresh level run the
level kernel's plain version."""
import numpy as np
import pytest
import torch

from libpll2_tpu import Partition as JPartition
from libpll2_tpu import TreeEngine as JTreeEngine
from libpll2_tpu import compute_gamma_cats as j_gamma_cats
from libpll2_tpu import optimize as jopt
from libpll2_tpu.io import maps as jmaps
from libpll2_tpu.ops import branch_sweep as jsweep
from libpll2_tpu.trees import random_utree as j_random_utree

import libpll2_tpu_torch as tp
from libpll2_tpu_torch import optimize as topt
from libpll2_tpu_torch.io import maps
from libpll2_tpu_torch.ops import branch_sweep as tsweep
from libpll2_tpu_torch.ops import levels as tlevels
from libpll2_tpu_torch.trees import create_operations, random_utree, traverse
from libpll2_tpu_torch.utils import simulate_alignment

CPU = "cpu"
TOL_LOGL = 5e-5                                # bench_validate.py:61-63
FREQS = [0.3, 0.2, 0.2, 0.3]
SUBST = [1.2, 2.5, 0.8, 1.1, 2.0, 1.0]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _perturb(tree, perturb):
    seen = set()
    for n in tree.nodes():
        for h in ([n] if n.is_tip() else list(n.ring())):
            if id(h) not in seen and h.back is not None:
                seen.add(id(h)), seen.add(id(h.back))
                h.length = h.back.length = h.length * perturb + 0.02


def _problem(n_taxa=14, sites=384, seed=21, perturb=1.7, dtype="float64",
             rate_scalers=False, jax=True):
    """tests/test_branch_sweep.py's problem: (JAX engine and tree), (port
    engine and tree)."""
    labels = [f"t{i}" for i in range(n_taxa)]
    headers, seqs = simulate_alignment(random_utree(labels, seed=seed),
                                       sites, FREQS, SUBST, alpha=0.9,
                                       seed=seed)
    by = dict(zip(headers, seqs))
    out = []
    for jax_side in ((True, False) if jax else (False,)):
        if jax_side:
            tree = j_random_utree(labels, seed=seed)
            part = JPartition(n_taxa, n_taxa - 2, 4, sites, 1,
                              2 * n_taxa - 3, 4, n_taxa - 2, dtype=dtype,
                              rate_scalers=rate_scalers)
            cm, gamma = jmaps.map_nt, j_gamma_cats
        else:
            tree = random_utree(labels, seed=seed)
            part = tp.Partition(n_taxa, n_taxa - 2, 4, sites, 1,
                                2 * n_taxa - 3, 4, n_taxa - 2, device=CPU,
                                dtype=getattr(torch, dtype),
                                rate_scalers=rate_scalers)
            cm, gamma = maps.map_nt, tp.compute_gamma_cats
        _perturb(tree, perturb)
        for t in tree.tips():
            part.set_tip_states(t.clv_index, cm, by[t.label])
        part.set_frequencies(0, FREQS)
        part.set_subst_params(0, SUBST)
        part.set_category_rates(gamma(0.9, 4))
        out += [part, tree]
    return out


def _edge_lengths(tree):
    out = {}
    seen = set()
    for n in tree.nodes():
        for h in ([n] if n.is_tip() else list(n.ring())):
            if h.back is not None and id(h) not in seen:
                seen.add(id(h)), seen.add(id(h.back))
                out[h.pmatrix_index] = h.length
    return out


@pytest.mark.parametrize("n_taxa,seed", [(4, 1), (9, 2), (14, 21), (33, 5),
                                         (64, 9)])
def test_schedule_equals_jax(n_taxa, seed):
    """build_smoothing_schedule `==` JAX's: the [n_steps, 13] table and
    n_aux."""
    labels = [f"t{i}" for i in range(n_taxa)]
    jt, tt = (j_random_utree(labels, seed=seed),
              random_utree(labels, seed=seed))
    n_nodes, k, e = 2 * n_taxa - 2, n_taxa - 2, 2 * n_taxa - 3
    want, jaux = jsweep.build_smoothing_schedule(jt, n_nodes, k, e)
    got, taux = tsweep.build_smoothing_schedule(tt, n_nodes, k, e)
    assert taux == jaux
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("passes", [1, 2])
def test_newton_smooth_all_matches_jax(passes):
    """14 x 384 float64: the tree's branches to 1e-8, the final logL to
    1e-10 and the partition's CLV rows after the sweep to 1e-10 of their
    largest entry, against JAX's newton_smooth_all."""
    jp, jt, tpart, tt = _problem()
    jeng = JTreeEngine(jp, jt, pallas=False)
    jeng.loglikelihood()       # JAX's sweep starts from the pmatrix buffer
    jl = jopt.newton_smooth_all(jeng, jt, passes=passes)
    eng = tp.TreeEngine(tpart, tt, pallas=False)
    lk0 = eng.loglikelihood()
    tl = topt.newton_smooth_all(eng, tt, passes=passes)
    assert tl == pytest.approx(jl, rel=1e-10)
    assert tl > lk0 + 1.0
    jlen, tlen = _edge_lengths(jt), _edge_lengths(tt)
    for k in jlen:
        assert tlen[k] == pytest.approx(jlen[k], rel=1e-8), k
    want = np.asarray(jp.clv)[:tpart.nodes]
    got = tpart.clv.numpy()[:tpart.nodes]
    assert np.max(np.abs(got - want)) <= 1e-10 * np.max(np.abs(want))
    np.testing.assert_allclose(tpart.pmatrix.numpy(), np.asarray(jp.pmatrix),
                               rtol=1e-10, atol=1e-14)


def test_sweep_starts_from_the_current_lengths():
    """The port's sweep builds its first refresh's P-matrices from the
    engine's branches: a sweep on a fresh engine equals one after an
    evaluation (JAX's reads the partition's pmatrix buffer, zeros on a
    fresh partition: ROADMAP C)."""
    lks = []
    for evaluate in (False, True):
        tpart, tt = _problem(jax=False)
        eng = tp.TreeEngine(tpart, tt, pallas=False)
        if evaluate:
            eng.loglikelihood()
        else:
            assert not bool(tpart.pmatrix.any())
        lks.append(topt.newton_smooth_all(eng, tt, passes=1))
    assert lks[0] == lks[1]
    jp, jt, _, _ = _problem()
    jl = jopt.newton_smooth_all(JTreeEngine(jp, jt, pallas=False), jt,
                                passes=1)
    assert abs(jl - lks[0]) > 100.0


@pytest.mark.parametrize("passes", [1, 2])
def test_sweep_after_the_gradient_route_matches_jax(passes):
    """The sweep after `maximize_loglikelihood` of the branches, which sets
    the engine's branches but not the tree's: evaluate, then sweep without
    `apply_branches_to_tree`. JAX's first refresh reads the P-matrices of
    the optimized branches from its pmatrix buffer and starts Newton from
    the tree's lengths; the port must do the same (ROADMAP C2). logL to
    1e-10 relative, the tree's branches and the engine's to 1e-10."""
    jp, jt, tpart, tt = _problem()
    kw = dict(steps=6, learning_rate=0.05, chunk=3, patience=10)
    groups = ("branches", "subst", "freqs")
    jeng = JTreeEngine(jp, jt, pallas=False)
    jopt.maximize_loglikelihood(jeng, groups, **kw)
    jl0 = jeng.loglikelihood()
    jl = jopt.newton_smooth_all(jeng, jt, passes=passes)
    eng = tp.TreeEngine(tpart, tt, pallas=False)
    topt.maximize_loglikelihood(eng, groups, **kw)
    tl0 = eng.loglikelihood()
    assert tl0 == pytest.approx(jl0, rel=1e-10)
    blen = _edge_lengths(tt)
    assert not np.allclose(eng.branches.numpy()[list(blen)],
                           list(blen.values()))
    tl = topt.newton_smooth_all(eng, tt, passes=passes)
    assert tl == pytest.approx(jl, rel=1e-10)
    jlen, tlen = _edge_lengths(jt), _edge_lengths(tt)
    for k in jlen:
        assert tlen[k] == pytest.approx(jlen[k], rel=1e-10), k
    np.testing.assert_allclose(eng.branches.numpy(),
                               np.asarray(jeng.branches), rtol=1e-10)


def test_newton_optimize_branches_matches_jax():
    """The step-by-step host loop against JAX's: logL to 1e-10, branches
    to 1e-8."""
    jp, jt, tpart, tt = _problem()
    jl = jopt.newton_optimize_branches(jp, jt, [0] * 4, passes=2)
    tl = topt.newton_optimize_branches(tpart, tt, [0] * 4, passes=2)
    assert tl == pytest.approx(jl, rel=1e-10)
    jlen, tlen = _edge_lengths(jt), _edge_lengths(tt)
    for k in jlen:
        assert tlen[k] == pytest.approx(jlen[k], rel=1e-8), k


def test_sweep_matches_host_loop():
    """tests/test_branch_sweep.py:test_sweep_matches_host_loop on the port:
    the sweep and the host loop reach one optimum."""
    part_a, tree_a = _problem(jax=False)
    part_b, tree_b = _problem(jax=False)
    eng = tp.TreeEngine(part_a, tree_a, pallas=False)
    lk0 = eng.loglikelihood()
    lk_dev = topt.newton_smooth_all(eng, tree_a, passes=8, iterations=8)
    lk_host = topt.newton_optimize_branches(part_b, tree_b, [0] * 4,
                                            passes=8, iterations=8)
    assert lk_dev > lk0 + 1.0
    assert lk_dev == pytest.approx(lk_host, abs=0.01)
    la, lb = _edge_lengths(tree_a), _edge_lengths(tree_b)
    for k in la:
        assert la[k] == pytest.approx(lb[k], rel=0.05, abs=2e-3), k


def test_sweep_improves_and_converges():
    """tests/test_branch_sweep.py:test_sweep_improves_and_converges on the
    port, on its default engine (the fused path)."""
    part, tree = _problem(n_taxa=10, sites=256, seed=3, jax=False)
    eng = tp.TreeEngine(part, tree)
    assert eng.execution_path == "fused"
    lk0 = eng.loglikelihood()
    lk1 = topt.newton_smooth_all(eng, tree, passes=1, iterations=8)
    lk2 = topt.newton_smooth_all(eng, tree, passes=4, iterations=8)
    assert lk1 > lk0
    assert lk2 >= lk1 - 1e-6
    lk3 = topt.newton_smooth_all(eng, tree, passes=1, iterations=8)
    assert abs(lk3 - lk2) < 1e-3 * abs(lk2) + 0.05


def test_per_rate_sweep_follows_jax():
    """A per-rate partition where scaling triggers (float32, 60 taxa): JAX's
    sweep decides every rescale per site and broadcasts the counts over the
    rates, and reaches the host loop's optimum (checked: it is no fault);
    the port does the same. Against JAX: logL within TOL_LOGL, branches
    within 1e-4."""
    jp, jt, tpart, tt = _problem(n_taxa=60, dtype="float32",
                                 rate_scalers=True)
    jeng = JTreeEngine(jp, jt, pallas=False)
    jeng.loglikelihood()
    jl = jopt.newton_smooth_all(jeng, jt, passes=2)
    eng = tp.TreeEngine(tpart, tt, pallas=False)
    tl = topt.newton_smooth_all(eng, tt, passes=2)
    assert int(np.asarray(jp.scale_buffer).max()) > 0
    assert tl == pytest.approx(jl, rel=TOL_LOGL)
    jlen, tlen = _edge_lengths(jt), _edge_lengths(tt)
    for k in jlen:
        assert tlen[k] == pytest.approx(jlen[k], rel=1e-4, abs=1e-6), k
    assert int(tpart.scale_buffer.max()) > 0


def test_sweep_runs_every_clv_op_through_level():
    """newton_sweep runs each step's CLV op as a one-op level and every
    refresh a level at a time through `level`: passes x steps + (passes +
    1) x levels calls, the step tables all views of one tensor; the plain
    version as `level` gives the wrapper's result."""
    _, _, tpart, tt = _problem(n_taxa=9, sites=96)
    eng = tp.TreeEngine(tpart, tt, pallas=False)
    ops, branches, pidx = create_operations(traverse(tt.vroot))
    steps, n_aux = tsweep.build_smoothing_schedule(
        tt, tpart.nodes, tpart.scale_buffers, tpart.prob_matrices)
    K = tpart.scale_buffers
    tables = tlevels.tables_to_device(tlevels.pack_pallas_levels(
        ops, tpart.tips, zero_scaler_row=K + n_aux + 1,
        trash_scaler_row=K + n_aux), CPU)
    st = tsweep.step_tables(steps, CPU)
    assert len(st) == len(steps)
    assert all(t.shape == (9, 1) and t.untyped_storage().data_ptr()
               == st[0].untyped_storage().data_ptr() for t in st)
    calls = []

    def counting(*args):
        calls.append(args[3].shape[1])
        tlevels.level_update_reference(*args)

    m = eng._model_args()
    pw, inv = eng._site_args()
    blen = torch.as_tensor(eng._branch_vector(branches, pidx))
    outs = [tsweep.newton_sweep(
        tpart.clv, tpart.scale_buffer, tpart.pmatrix, blen, *m, tables,
        steps, pw, inv, tpart.scale_threshold, tpart.scale_factor, passes=2,
        n_aux=n_aux, level=lv) for lv in (counting, tlevels.level_update)]
    assert len(calls) == 2 * len(steps) + 3 * len(tables)
    assert calls.count(1) >= 2 * len(steps)
    for a, b in zip(*outs):
        assert torch.equal(a, b)
