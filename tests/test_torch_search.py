"""The port's topology search (`libpll2_tpu_torch.search.TreeSearch`) on
the CPU: tests/test_search.py's cases carried over on the port, and its
rounds against libpll2_tpu's from the same start.

Both packages build the same tree from one seed and the same alignment
(simulated once). The port's partitions are float64 on the CPU unless a
test says otherwise; the kernels' wrappers run their plain versions for
CPU tensors. Rounds from the same start must accept the same moves as
JAX's and end at the same logL to 1e-9 relative (float64; the candidate
scores differ in summation order only). JAX's no-recompile case is an XLA
artefact and is not carried over; its mesh case waits for ROADMAP A8."""
import numpy as np
import pytest
import torch

from libpll2_tpu import Partition as JPartition
from libpll2_tpu import compute_gamma_cats as j_gamma_cats
from libpll2_tpu import constants as JC
from libpll2_tpu import search as jsearch
from libpll2_tpu import trees as jtrees
from libpll2_tpu.io import maps as jmaps

import libpll2_tpu_torch as tp
from libpll2_tpu_torch import constants as C
from libpll2_tpu_torch import convert
from libpll2_tpu_torch import trees as ttrees
from libpll2_tpu_torch.io import maps
from libpll2_tpu_torch.search import (TreeSearch, _all_edges,
                                      _internal_edges, _radius_targets)
from libpll2_tpu_torch.trees import (create_operations, moves,
                                     random_alignment, random_utree,
                                     traverse)
from libpll2_tpu_torch.utils import simulate_alignment

CPU = "cpu"
N_TAXA, N_SITES = 12, 500


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these small problems: the test workers share
    the cores, and torch's default thread pool a worker then spends most of
    its time waiting (measured 20x slower under load)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(perturb: int, n=N_TAXA, sites=N_SITES, seed=33,
           dtype=torch.float64, jax=False):
    """tests/test_search.py's problem: a random tree, an alignment
    simulated on it, `perturb` seeded NNI moves; the port's partition and
    tree, or JAX's with `jax`."""
    pkg = jtrees if jax else ttrees
    labels = [f"t{i}" for i in range(n)]
    headers, seqs = simulate_alignment(random_utree(labels, seed=seed),
                                       sites, [0.25] * 4, [1, 3, 1, 1, 3, 1],
                                       alpha=0.9, seed=seed)
    tree = pkg.random_utree(labels, seed=seed)
    edges_of = jsearch._internal_edges if jax else _internal_edges
    rng = np.random.default_rng(1)
    for _ in range(perturb):
        edges = edges_of(tree)
        pkg.moves.nni(edges[rng.integers(len(edges))],
                      C.UTREE_MOVE_NNI_LEFT, None)
    if jax:
        part = JPartition(n, n - 2, 4, sites, 1, 2 * n - 3, 4, n - 2)
        cm, gamma = jmaps.map_nt, j_gamma_cats
    else:
        part = tp.Partition(n, n - 2, 4, sites, 1, 2 * n - 3, 4, n - 2,
                            device=CPU, dtype=dtype)
        cm, gamma = maps.map_nt, tp.compute_gamma_cats
    by = dict(zip(headers, seqs))
    for tip in tree.tips():
        part.set_tip_states(tip.clv_index, cm, by[tip.label])
    part.set_frequencies(0, [0.25] * 4)
    part.set_subst_params(0, [1, 3, 1, 1, 3, 1])
    part.set_category_rates(gamma(0.9, 4))
    return part, tree


# ------------------------------------------- tests/test_search.py, ported
def test_nni_round_improves_perturbed_tree():
    part, tree = _setup(perturb=3)
    search = TreeSearch(part, tree)
    lk0 = search.evaluate()
    lk, accepted = search.nni_round()
    assert accepted >= 1
    assert lk > lk0 + 1.0
    want = jsearch.TreeSearch(*_setup(perturb=3, jax=True)).nni_round()
    assert accepted == want[1]
    np.testing.assert_allclose(lk, want[0], rtol=1e-9)


def test_search_converges_and_rollback_is_clean():
    part, tree = _setup(perturb=2)
    search = TreeSearch(part, tree)
    lk_final = search.run(max_rounds=5, use_spr=True)
    # converged: one more NNI round accepts nothing
    lk_again, accepted = search.nni_round()
    assert accepted == 0
    np.testing.assert_allclose(lk_again, lk_final, rtol=1e-12)


def test_batched_nni_matches_sequential():
    """All candidates scored at once find the same optimum as move-by-move
    rescoring (steepest ascent against first improvement: at least the
    same logL on this easy recovery)."""
    lk_seq, _ = TreeSearch(*_setup(perturb=3)).nni_round()
    lk_bat, accepted = TreeSearch(*_setup(perturb=3)).nni_round_batched()
    assert accepted >= 1
    assert lk_bat >= lk_seq - 1e-6


def test_evaluate_topologies_agrees_with_single_eval():
    part, tree = _setup(perturb=1)
    eng = tp.TreeEngine(part, tree, level_schedule=False, pallas=False)
    ops, br, pidx = create_operations(traverse(tree.vroot))
    scores = eng.evaluate_topologies([(ops, br, pidx, tree.vroot)] * 3)
    np.testing.assert_allclose(scores, [eng.loglikelihood()] * 3,
                               rtol=1e-12)


def test_search_on_true_tree_accepts_nothing_worse():
    part, tree = _setup(perturb=0)
    search = TreeSearch(part, tree)
    lk0 = search.evaluate()
    lk, accepted = search.nni_round()
    assert lk >= lk0 - 1e-9


def test_spr_round_batched_recovers_tree():
    """Batched steepest-ascent SPR reaches at least the sequential SPR
    round's logL on an easy recovery problem."""
    lk_seq, _ = TreeSearch(*_setup(perturb=3)).spr_round()
    s = TreeSearch(*_setup(perturb=3))
    lk_bat, accepted = s.spr_round_batched(batch=32)
    assert accepted >= 1
    assert lk_bat >= lk_seq - 1e-6


def test_spr_radius_targets_valid():
    """Radius-limited enumeration: every target is a valid regraft (not
    in the pruned subtree, not the identity neighbourhood) and a subset of
    the full filtered target set."""
    tree = random_utree([f"t{i}" for i in range(24)], seed=7)
    for p in _internal_edges(tree)[:8]:
        full = set()
        for r in _all_edges(tree):
            if r in (p, p.back, p.next, p.next.back,
                     p.next.next, p.next.next.back):
                continue
            if moves.utree_find(p.back, r) or r.back is None:
                continue
            full.add(id(r))
            full.add(id(r.back))
        rt = _radius_targets(p, 5)
        assert rt, "radius enumeration found no targets"
        assert len({id(r) for r in rt}) == len(rt)      # no duplicates
        for r in rt:
            assert id(r) in full or id(r.back) in full


def test_spr_radius_round_improves():
    search = TreeSearch(*_setup(perturb=4))
    lk0 = search.evaluate()
    lk, accepted = search.spr_round_batched(radius=4)
    assert accepted >= 1 and lk > lk0 + 0.5


def test_packed_candidates_match_object_pipeline():
    """pack_candidate + evaluate_packed (the search loop's one-pass path)
    equal evaluate_topologies over the Operation-object pipeline, and the
    batched SPR round takes the native builder on the fused path
    (float32)."""
    part, tree = _setup(perturb=0, dtype=torch.float32)
    eng = tp.TreeEngine(part, tree)
    assert eng.use_fused
    packed, objs = [], []
    for edge in _internal_edges(tree)[:4]:
        rb = moves.Rollback()
        moves.nni(edge, C.UTREE_MOVE_NNI_LEFT, rb)
        vr = tree.vroot
        pc = eng.pack_candidate(vr)
        assert pc is not None
        packed.append(pc)
        ops, br, pidx = create_operations(traverse(vr))
        objs.append((ops, br, pidx,
                     (vr.clv_index, vr.scaler_index, vr.back.clv_index,
                      vr.back.scaler_index, vr.pmatrix_index)))
        moves.rollback_move(rb)
    np.testing.assert_allclose(eng.evaluate_packed(packed),
                               eng.evaluate_topologies(objs), rtol=1e-6)
    search = TreeSearch(part, tree)
    lk0 = search.evaluate()
    assert search._engine.use_fused
    built = []
    native = search._native_candidates
    search._native_candidates = lambda mv: built.append(len(mv)) or \
        native(mv)
    lk, acc = search.spr_round_batched(radius=3)
    assert lk >= lk0 and built


# ------------------------------------------------------ parity with JAX
def test_nni_round_skips_an_edge_an_accepted_move_made_terminal():
    """The first-improvement round lists its edges once; an accepted move
    can relink one of them to a tip. JAX's round raises PllError there;
    the port's skips it (ROADMAP C) and agrees with its own batched
    round."""
    jpart, jtree = _setup(perturb=3, n=10, sites=120, seed=1, jax=True)
    with pytest.raises(JC.PllError, match="terminal branch"):
        jsearch.TreeSearch(jpart, jtree).nni_round()
    part, tree = _setup(perturb=3, n=10, sites=120, seed=1)
    search = TreeSearch(part, tree)
    lk0 = search.evaluate()
    lk, accepted = search.nni_round()
    assert accepted >= 1 and lk > lk0


def _fuzz_problem(seed):
    """tests/test_spr_stream.py:test_streamed_round_fuzz_matches_batched's
    random configuration: (build(jax) -> (partition, tree), states)."""
    rng = np.random.default_rng(seed)
    states = int(rng.choice([4, 4, 20]))
    n = int(rng.integers(8, 15))
    n_sites = int(rng.integers(48, 160))
    repeats = bool(rng.integers(0, 3) == 0)
    rate_scalers = bool(rng.integers(0, 4) == 0)
    alpha = float(rng.uniform(0.3, 2.0))
    asc = None
    if not rate_scalers and not repeats and rng.integers(0, 3) == 0:
        asc = int(rng.integers(1, 4))
    alphabet = "ACGT" if states == 4 else "ARNDCQEGHILKMFPSTWYV"
    headers, seqs = random_alignment(n, n_sites, alphabet=alphabet,
                                     seed=seed)
    if repeats:
        src = rng.integers(0, max(n_sites // 3, 1), size=n_sites)
        seqs = ["".join(s[j] for j in src) for s in seqs]

    def build():
        rng2 = np.random.default_rng(seed + 1)
        jtree = jtrees.random_utree(headers, seed=seed)
        kw = {}
        if repeats:
            kw["site_repeats"] = True
        if rate_scalers:
            kw["rate_scalers"] = True
        if asc:
            kw["asc_bias"] = JC.AscBias(asc)
        jp = JPartition(n, n - 2, states, n_sites, 1, 2 * n - 3, 4, n - 2,
                        **kw)
        by = dict(zip(headers, seqs))
        cm = jmaps.map_nt if states == 4 else jmaps.map_aa
        for t in jtree.tips():
            jp.set_tip_states(t.clv_index, cm, by[t.label])
        jp.set_frequencies(0, rng2.dirichlet(np.ones(states) * 10))
        jp.set_subst_params(
            0, rng2.uniform(0.5, 2.0, states * (states - 1) // 2))
        jp.set_category_rates(j_gamma_cats(alpha, 4))
        if asc:
            jp.set_asc_state_weights([2] * states)
        return jp, jtree

    return build, headers


def _port_of(jp):
    state = {k: getattr(jp, k) for k in convert.STATE_KEYS}
    state["_invariant_valid"] = jp._invariant_valid
    if jp.repeats is not None:
        state.update({k: getattr(jp, k, None) for k in convert.REPEATS_KEYS})
    return convert.partition_from_numpy(state, device=CPU,
                                        dtype=torch.float64)


@pytest.mark.parametrize("seed", [203, 206, 217, 225])
def test_streamed_round_fuzz_matches_batched_and_jax(seed):
    """JAX's fuzz seeds: the port's streamed and batched SPR rounds from
    the same start accept the same moves as JAX's (its batched round,
    which its own test holds to its streamed one) and end at its logL."""
    build, headers = _fuzz_problem(seed)
    jp, jtree = build()
    want = jsearch.TreeSearch(jp, jtree).spr_round_batched(radius=3, seed=2)
    got = {}
    for kind in ("streamed", "batched"):
        jp, _ = build()
        s = TreeSearch(_port_of(jp), random_utree(headers, seed=seed))
        got[kind] = getattr(s, f"spr_round_{kind}")(radius=3, seed=2)
    assert s._streamed_eligible()
    for kind, (best, acc) in got.items():
        assert acc == want[1], kind
        np.testing.assert_allclose(best, want[0], rtol=1e-9, err_msg=kind)


def test_streamed_rounds_subsampled_and_nni_match_jax():
    """max_candidates subsampling consumes the rng as the batched rounds
    do (JAX's test_streamed_round_matches_batched_subsampled), and an NNI
    streamed round after it, against JAX's rounds from the same start."""
    def jax_problem():
        return _jax_dna(16, 96, 13)

    jp, jtree = jax_problem()
    js = jsearch.TreeSearch(jp, jtree)
    want = (js.spr_round_streamed(radius=4, max_candidates=3, seed=5),
            js.nni_round_streamed())
    jp, _ = jax_problem()
    s = TreeSearch(_port_of(jp), random_utree(
        [f"t{i}" for i in range(16)], seed=13))
    got = (s.spr_round_streamed(radius=4, max_candidates=3, seed=5),
           s.nni_round_streamed())
    for (gb, ga), (wb, wa) in zip(got, want):
        assert ga == wa
        np.testing.assert_allclose(gb, wb, rtol=1e-9)


def _jax_dna(n, sites, seed):
    headers, seqs = random_alignment(n, sites, seed=seed)
    jtree = jtrees.random_utree(headers, seed=seed)
    jp = JPartition(n, n - 2, 4, sites, 1, 2 * n - 3, 4, n - 2)
    by = dict(zip(headers, seqs))
    for t in jtree.tips():
        jp.set_tip_states(t.clv_index, jmaps.map_nt, by[t.label])
    rng = np.random.default_rng(seed)
    jp.set_frequencies(0, rng.dirichlet(np.ones(4) * 10))
    jp.set_subst_params(0, rng.uniform(0.5, 2.0, size=6))
    jp.set_category_rates(j_gamma_cats(0.8, 4))
    return jp, jtree


class _Proxy:
    """An engine of another type than TreeEngine, delegating to one."""

    def __init__(self, eng):
        self._eng = eng

    def __getattr__(self, name):
        return getattr(self._eng, name)


def test_ineligible_engines_take_the_batched_rounds():
    """An injected engine that is not a TreeEngine, and one with
    per-edge heterotachy (edge_params), are not eligible: the streamed
    rounds run the batched ones."""
    jp, _ = _jax_dna(12, 64, 3)
    labels = [f"t{i}" for i in range(12)]
    want = TreeSearch(_port_of(jp), random_utree(labels, seed=3)) \
        .spr_round_batched(radius=3)
    tree = random_utree(labels, seed=3)
    part = _port_of(jp)
    s = TreeSearch(part, tree, engine=_Proxy(tp.TreeEngine(part, tree)))
    assert not s._streamed_eligible()
    assert s.spr_round_streamed(radius=3) == want
    tree = random_utree(labels, seed=3)
    part = _port_of(jp)
    s = TreeSearch(part, tree,
                   edge_params=np.zeros(part.prob_matrices, np.int64))
    s._ensure_engine()
    assert not s._streamed_eligible()
    best, acc = s.nni_round_streamed()
    assert np.isfinite(best)
