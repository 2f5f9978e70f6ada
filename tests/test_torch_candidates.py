"""Candidate scoring in the port (`TreeEngine.evaluate_topologies`,
`pack_candidate`, `evaluate_packed`, `evaluate_packed_arrays`, the fused
traversal's candidate form, `trees/moves.py`) against libpll2_tpu on the
CPU.

Both packages build the same partition (JAX's, carried over with
libpll2_tpu_torch.convert) and each builds its NNI candidates with its own
`trees.moves` on its own copy of the tree. Tolerances:
  * host code (moves, `fused_candidate_from_tree`, `pack_candidate`): `==`;
  * float64: the port's scores against JAX's `pallas=False` engine (its XLA
    scan, or its pooled path), 1e-12 relative a candidate: the two differ
    in summation order only;
  * float32: against JAX's `pallas="interpret"` engine (its Pallas kernels
    under the candidate vmap, in interpret mode), 1e-6 relative a
    candidate, the budget JAX holds its own two paths to
    (tests/test_pallas.py:157); protein 'split' and 'bf16' at TOL_LOGL 5e-5
    (bench_validate.py:61-63), the budget of the port's single-topology
    protein engine against JAX's (tests/test_torch_protein.py): both
    'split's are the same hi/lo bf16 product and both 'bf16's round the
    same operands, but a last-bit difference of a float32 sum can round a
    value to the other bf16 neighbour;
  * the port against itself: each score against `set_topology` +
    `loglikelihood()` of that candidate at 1e-12 (float64) and 1e-6
    (float32: its P-matrices come from one batch of K * E edges);
    `evaluate_packed(_arrays)` against `evaluate_topologies` `==`.
Every construction passes device="cpu"; the kernels' wrappers run their
plain versions for CPU tensors."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libpll2_tpu import Operation as JOperation
from libpll2_tpu import Partition as JPartition
from libpll2_tpu import TreeEngine as JTreeEngine
from libpll2_tpu import compute_gamma_cats as j_gamma_cats
from libpll2_tpu import constants as JC
from libpll2_tpu import trees as jtrees
from libpll2_tpu.io import maps as jmaps
from libpll2_tpu.ops import pallas_fused as jfused
from libpll2_tpu.trees import moves as jmoves

import libpll2_tpu_torch as tp
from libpll2_tpu_torch import constants as C
from libpll2_tpu_torch import convert
from libpll2_tpu_torch import trees as ttrees
from libpll2_tpu_torch.engine import CANDIDATE_CHUNK
from libpll2_tpu_torch.ops import fused as tfused
from libpll2_tpu_torch.partition import Operation
from libpll2_tpu_torch.trees import moves as tmoves
from libpll2_tpu_torch.utils import simulate_alignment

CPU = "cpu"
TOL_LOGL = 5e-5                                # bench_validate.py:61-63
FREQS = [0.3, 0.2, 0.2, 0.3]
SUBST = [1.0, 2.0, 1.0, 1.0, 2.0, 1.0]
FREQS2 = [0.1, 0.4, 0.4, 0.1]
SUBST2 = [2.0, 5.0, 0.5, 1.0, 6.0, 1.0]


def _labels(n):
    return [f"t{i}" for i in range(n)]


def _trees(n, seed):
    """The same random topology as a JAX and a port tree."""
    return (jtrees.random_utree(_labels(n), seed=seed),
            ttrees.random_utree(_labels(n), seed=seed))


def _raw_values(sites, states, seed):
    return np.random.default_rng(seed).uniform(0.05, 1.0, (sites, states))


# (taxa, sites, states, rates, options) of each problem; options:
# rate_scalers, site_repeats, raw (tips set with set_tip_clv), models (2:
# edge_params with two rate matrices)
PROBLEMS = {
    "dna": (12, 200, 4, 4, {}),
    "per_rate": (12, 200, 4, 4, dict(rate_scalers=True)),
    "raw_tips": (12, 200, 4, 4, dict(raw=(1, 6))),
    "edge_params": (12, 200, 4, 4, dict(models=2)),
    "protein": (8, 120, 20, 4, {}),
    "repeats": (12, 240, 4, 4, dict(site_repeats=True)),
}


def _jax_partition(name, dtype, seed=5):
    """The problem's JAX partition and tree (a second tree for the port)."""
    taxa, sites, states, rates, opt = PROBLEMS[name]
    jtree, ttree = _trees(taxa, seed)
    if states == 4:
        freqs, subst, cm = FREQS, SUBST, jmaps.map_nt
    else:
        freqs = [1.0 / states] * states
        subst = [1.0] * (states * (states - 1) // 2)
        cm = jmaps.map_aa
    headers, seqs = simulate_alignment(ttree, sites, freqs, subst,
                                       alpha=0.9, seed=seed)
    if opt.get("site_repeats"):
        # conserved columns, so that classes repeat
        cols = np.array([list(s) for s in seqs])
        keep = np.random.default_rng(seed).random(cols.shape[1]) < 0.6
        cols[:, keep] = cols[:1, keep]
        seqs = ["".join(r) for r in cols]
    by = dict(zip(headers, seqs))
    models = opt.get("models", 1)
    jp = JPartition(jtree.tip_count, jtree.inner_count, states, sites,
                    models, jtree.edge_count, rates, jtree.inner_count,
                    dtype=dtype, rate_scalers=opt.get("rate_scalers", False),
                    site_repeats=opt.get("site_repeats", False))
    for tip in jtree.tips():
        jp.set_tip_states(tip.clv_index, cm, by[tip.label])
    for i in opt.get("raw", ()):
        jp.set_tip_clv(i, _raw_values(sites, states, i))
    jp.set_frequencies(0, freqs)
    jp.set_subst_params(0, subst)
    if models == 2:
        jp.set_frequencies(1, FREQS2)
        jp.set_subst_params(1, SUBST2)
    jp.set_category_rates(j_gamma_cats(0.9, rates))
    return jp, jtree, ttree


def _state(jp):
    state = {k: getattr(jp, k) for k in convert.STATE_KEYS}
    state["_invariant_valid"] = jp._invariant_valid
    if jp.repeats is not None:
        state.update({k: getattr(jp, k, None) for k in convert.REPEATS_KEYS})
    return state


def _port(jp, dtype):
    return convert.partition_from_numpy(_state(jp), device=CPU, dtype=dtype)


def _edge_params(name, tree):
    if PROBLEMS[name][4].get("models") != 2:
        return None
    return np.arange(tree.edge_count) % 2


def _inner_edges(tree):
    """Every half-edge between two inner nodes, in one order for both
    packages' copies of a tree."""
    return [h for n in tree.nodes() if not n.is_tip() for h in n.ring()
            if h.back is not None and not h.back.is_tip()]


def _root_tuple(vr):
    return (vr.clv_index, vr.scaler_index, vr.back.clv_index,
            vr.back.scaler_index, vr.pmatrix_index)


def _nni_candidates(tree, mv, trees_mod, count=None):
    """(operations, branches, pmatrix_indices, root 5-tuple) of the first
    `count` (all) NNI neighbours of `tree` (`nni_neighbours`' order, which
    reads only the links and so enumerates either package's copy alike),
    built with the package's own moves and rolled back."""
    out = []
    for h, move in tmoves.nni_neighbours(tree)[:count]:
        rb = mv.Rollback()
        mv.nni(h, move, rb)
        ops, br, pidx = trees_mod.create_operations(
            trees_mod.traverse(tree.vroot))
        out.append((ops, br, pidx, _root_tuple(tree.vroot)))
        mv.rollback_move(rb)
    return out


def _jax_candidates(jtree, count=None):
    return _nni_candidates(jtree, jmoves, jtrees, count)


def _port_candidates(ttree, count=None):
    return _nni_candidates(ttree, tmoves, ttrees, count)


def _current(tree, trees_mod, root_as_node=True):
    """The tree's own topology as a candidate, its root a live node."""
    ops, br, pidx = trees_mod.create_operations(
        trees_mod.traverse(tree.vroot))
    return (ops, br, pidx, tree.vroot if root_as_node
            else _root_tuple(tree.vroot))


def _unfusable(candidate, op_type):
    """The candidate with its first op's scaler taken away: the fused
    kernel needs one on every op, so `pack_fused_schedule` refuses it."""
    ops, br, pidx, root = candidate
    o = ops[0]
    bad = op_type(o.parent_clv_index, -1, o.child1_clv_index,
                  o.child1_matrix_index, o.child1_scaler_index,
                  o.child2_clv_index, o.child2_matrix_index,
                  o.child2_scaler_index)
    return [bad] + list(ops[1:]), br, pidx, root


def _assert_rel(got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want) / np.abs(want)
    assert np.all(np.isfinite(got)) and err.max() <= rtol, err.max()


# ---------------------------------------------------------------- moves
def _half_edges(tree):
    return [h for n in tree.nodes()
            for h in ([n] if n.is_tip() else list(n.ring()))]


def _edge_state(tree):
    return [(h.pmatrix_index, h.length, h.back.clv_index)
            for h in _half_edges(tree)]


@pytest.mark.parametrize("seed", [1, 2])
def test_nni_and_rollback_match_jax(seed):
    jt, tt = _trees(14, seed)
    start = jtrees.export_newick(jt.vroot)
    assert ttrees.export_newick(tt.vroot) == start
    for jh, th in zip(_inner_edges(jt), _inner_edges(tt)):
        for move in (C.UTREE_MOVE_NNI_LEFT, C.UTREE_MOVE_NNI_RIGHT):
            jrb, trb = jmoves.Rollback(), tmoves.Rollback()
            jmoves.nni(jh, move, jrb)
            tmoves.nni(th, move, trb)
            assert (ttrees.export_newick(tt.vroot)
                    == jtrees.export_newick(jt.vroot))
            assert _edge_state(tt) == _edge_state(jt)
            assert jmoves.rollback_move(jrb) == tmoves.rollback_move(trb)
            assert ttrees.export_newick(tt.vroot) == start
    tip = next(n for n in tt.nodes() if n.is_tip())
    with pytest.raises(tp.PllError) as err:
        tmoves.nni(tip, C.UTREE_MOVE_NNI_LEFT)
    assert err.value.errno == C.ERROR_NNI_TERMINALBRANCH
    with pytest.raises(tp.PllError):
        tmoves.nni(_inner_edges(tt)[0], 7)


@pytest.mark.parametrize("seed", [3, 4])
def test_spr_and_rollback_match_jax(seed):
    """SPR with `safe` from every inner half-edge onto every third
    half-edge: the same refusals, returned lengths and matrix indices,
    newick and per-edge state after the move and after the rollback."""
    jt, tt = _trees(12, seed)
    start = jtrees.export_newick(jt.vroot)
    jh, th = _half_edges(jt), _half_edges(tt)
    moved = 0
    for p in range(len(jh)):
        if jh[p].next is None:
            continue
        for r in range(0, len(jh), 3):
            outcome = []
            for h, mv, rb in ((jh, jmoves, jmoves.Rollback()),
                              (th, tmoves, tmoves.Rollback())):
                try:
                    outcome.append((mv.spr(h[p], h[r], rb, safe=True), rb))
                except (JC.PllError, C.PllError) as exc:
                    outcome.append((exc.errno, None))
            (jres, jrb), (tres, trb) = outcome
            assert jres == tres
            if jrb is None:
                continue
            moved += 1
            assert (ttrees.export_newick(tt.vroot)
                    == jtrees.export_newick(jt.vroot))
            assert _edge_state(tt) == _edge_state(jt)
            assert jmoves.rollback_move(jrb) == tmoves.rollback_move(trb)
            assert ttrees.export_newick(tt.vroot) == start
            assert _edge_state(tt) == _edge_state(jt)
    assert moved > 20


def test_utree_find_matches_jax():
    jt, tt = _trees(10, 6)
    jh, th = _half_edges(jt), _half_edges(tt)
    for i in range(len(jh)):
        for j in range(0, len(jh), 4):
            assert (tmoves.utree_find(th[i].back, th[j])
                    == jmoves.utree_find(jh[i].back, jh[j]))


@pytest.mark.parametrize("taxa", [4, 11])
def test_nni_neighbours_are_the_full_neighbourhood(taxa):
    """2 x (taxa - 3) moves, each to a topology of its own and none the
    tree's; the same moves made by JAX's package on its copy of the tree
    give the same newick."""
    jt, tt = _trees(taxa, 2)
    start = ttrees.export_newick(tt.vroot)
    got = []
    for (jh, move), (th, tmove) in zip(tmoves.nni_neighbours(jt),
                                       tmoves.nni_neighbours(tt)):
        assert move == tmove
        jrb, trb = jmoves.Rollback(), tmoves.Rollback()
        jmoves.nni(jh, move, jrb)
        tmoves.nni(th, move, trb)
        got.append(ttrees.export_newick(tt.vroot))
        assert got[-1] == jtrees.export_newick(jt.vroot)
        jmoves.rollback_move(jrb)
        tmoves.rollback_move(trb)
    assert len(got) == len(set(got)) == 2 * (taxa - 3)
    assert start not in got


# ------------------------------------------------- packing a candidate
@pytest.mark.parametrize("raw", [False, True])
def test_fused_candidate_from_tree_matches_jax(raw):
    """The one-walk packer equals JAX's `==` and the port's own
    pack_fused_schedule(create_operations(traverse(...))) on every NNI
    neighbour of a 16-taxon tree."""
    jt, tt = _trees(16, 8)
    rows = None
    if raw:
        rows = np.full(16, -1, np.int32)
        rows[[2, 5, 11]] = [0, 1, 2]
    n_mats = tt.edge_count
    checked = 0
    for jh, th in zip(_inner_edges(jt), _inner_edges(tt)):
        jrb, trb = jmoves.Rollback(), tmoves.Rollback()
        jmoves.nni(jh, C.UTREE_MOVE_NNI_RIGHT, jrb)
        tmoves.nni(th, C.UTREE_MOVE_NNI_RIGHT, trb)
        got = tfused.fused_candidate_from_tree(tt.vroot, 16, n_mats, rows)
        want = jfused.fused_candidate_from_tree(jt.vroot, 16, n_mats, rows)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert got[2] == want[2] and got[3] == want[3]
        ops, br, pidx = ttrees.create_operations(ttrees.traverse(tt.vroot))
        table, n_slots = tfused.pack_fused_schedule(
            ops, 16, (tt.vroot.clv_index, tt.vroot.back.clv_index), rows)
        np.testing.assert_array_equal(got[0], table)
        assert got[3] == n_slots
        np.testing.assert_array_equal(got[1][np.asarray(pidx)], br)
        jmoves.rollback_move(jrb)
        tmoves.rollback_move(trb)
        checked += 1
    assert checked >= 20


def test_fused_candidate_from_tree_refuses_scalerless_node():
    _, tt = _trees(10, 2)
    node = next(n for n in tt.nodes() if not n.is_tip())
    for h in node.ring():
        h.scaler_index = -1
    assert tfused.fused_candidate_from_tree(tt.vroot, 10, tt.edge_count) \
        == (None, None, None, 0)


@pytest.mark.parametrize("name", ["dna", "raw_tips"])
def test_pack_candidate_matches_jax(name):
    jp, jt, tt = _jax_partition(name, jnp.float32)
    je = JTreeEngine(jp, jt, pallas="interpret")
    te = tp.TreeEngine(_port(jp, torch.float32), tt)
    assert je.use_fused and te.use_fused
    for jh, th in list(zip(_inner_edges(jt), _inner_edges(tt)))[:6]:
        jrb, trb = jmoves.Rollback(), tmoves.Rollback()
        jmoves.nni(jh, C.UTREE_MOVE_NNI_LEFT, jrb)
        tmoves.nni(th, C.UTREE_MOVE_NNI_LEFT, trb)
        got, want = te.pack_candidate(tt.vroot), je.pack_candidate(jt.vroot)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
        jmoves.rollback_move(jrb)
        tmoves.rollback_move(trb)


def test_pack_candidate_is_none_off_the_fused_path():
    jp, _, tt = _jax_partition("dna", jnp.float32)
    te = tp.TreeEngine(_port(jp, torch.float32), tt, pallas="levels-kernel")
    assert te.pack_candidate(tt.vroot) is None
    with pytest.raises(tp.PllError, match="fused path"):
        te.evaluate_packed([tfused.fused_candidate_from_tree(
            tt.vroot, tt.tip_count, tt.edge_count)])


# ----------------------------------------------- the candidate form
@pytest.mark.parametrize("states", [4, 20])
def test_traversal_candidate_form_is_each_candidate_alone(states):
    """The candidate form's outputs [K, ...] equal K one-topology walks,
    and one topology is the form's K = 1."""
    name = "dna" if states == 4 else "protein"
    jp, _, tt = _jax_partition(name, jnp.float32)
    te = tp.TreeEngine(_port(jp, torch.float32), tt)
    cands = _port_candidates(tt, 3)
    tables = np.stack([tfused.pack_fused_schedule(
        c[0], tt.tip_count, (c[3][0], c[3][2]))[0] for c in cands])
    rng = np.random.default_rng(0)
    pm = torch.tensor(rng.uniform(0.01, 1, (3, tt.edge_count, 4, states,
                                            states)), dtype=torch.float32)
    kw = dict(rates=4, states=states, n_slots=8,
              threshold=C.SCALE_THRESHOLD_F32, factor=C.SCALE_FACTOR_F32)
    codes = te._tip_codes()
    got = tfused.fused_traversal(codes, pm, torch.tensor(tables), **kw)
    for k in range(3):
        one = tfused.fused_traversal(codes, pm[k], torch.tensor(tables[k]),
                                     **kw)
        for g, w in zip(got, one):
            assert torch.equal(g[k], w)
    one = tfused.fused_traversal(codes, pm[:1], torch.tensor(tables[:1]),
                                 **kw)
    for g, w in zip(one, tfused.fused_traversal(
            codes, pm[0], torch.tensor(tables[0]), **kw)):
        assert g.shape[0] == 1 and torch.equal(g[0], w)


# ------------------------------------------------ engines against JAX
# the port's engine options per case, JAX's problem, and the candidates'
# kind: 'nni', 'unfusable' (an op without a scaler in the batch)
F64_CASES = {
    "dna": ("dna", dict(), "nni"),
    "per_rate": ("per_rate", dict(), "nni"),
    "raw_tips": ("raw_tips", dict(), "nni"),
    "edge_params": ("edge_params", dict(), "nni"),
    "protein": ("protein", dict(), "nni"),
    "dense_unfusable": ("dna", dict(), "unfusable"),
    "levels_engine": ("dna", dict(pallas="levels-kernel"), "nni"),
    "scan_engine": ("dna", dict(pallas=False, level_schedule=False), "nni"),
    "pool_pallas": ("repeats", dict(pallas="pool"), "nni"),
    "repeats_dense_fused": ("repeats", dict(), "nni"),
    "repeats_unfusable": ("repeats", dict(), "unfusable"),
}
PATHS = {"levels_engine": "levels-kernel", "scan_engine": "scan",
         "pool_pallas": "pool-pallas", "repeats_dense_fused":
         "repeats-dense-fused", "repeats_unfusable": "repeats-dense-fused"}


def _batches(kind, jt, tt, count=6):
    jc, tc = _jax_candidates(jt, count), _port_candidates(tt, count)
    jc.append(_current(jt, jtrees, root_as_node=True))
    tc.append(_current(tt, ttrees, root_as_node=True))
    if kind == "unfusable":
        jc.append(_unfusable(jc[0], JOperation))
        tc.append(_unfusable(tc[0], Operation))
    return jc, tc


@pytest.mark.parametrize("case", sorted(F64_CASES))
def test_evaluate_topologies_f64_matches_jax(case):
    name, kw, kind = F64_CASES[case]
    jp, jt, tt = _jax_partition(name, jnp.float64)
    ep = _edge_params(name, jt)
    je = JTreeEngine(jp, jt, pallas=False, edge_params=ep)
    te = tp.TreeEngine(_port(jp, torch.float64), tt, edge_params=ep, **kw)
    assert te.execution_path == PATHS.get(case, "fused")
    jc, tc = _batches(kind, jt, tt)
    _assert_rel(te.evaluate_topologies(tc), je.evaluate_topologies(jc),
                1e-12)


F32_CASES = {
    "dna": ("dna", dict(), 1e-6),
    "per_rate": ("per_rate", dict(), 1e-6),
    "raw_tips": ("raw_tips", dict(), 1e-6),
    "edge_params": ("edge_params", dict(), 1e-6),
    "protein_split": ("protein", dict(mxu="split"), TOL_LOGL),
    "protein_bf16": ("protein", dict(mxu="bf16"), TOL_LOGL),
    "repeats_dense_fused": ("repeats", dict(), 1e-6),
}


@pytest.mark.parametrize("case", sorted(F32_CASES))
def test_evaluate_topologies_f32_matches_jax_interpret(case):
    name, kw, rtol = F32_CASES[case]
    jp, jt, tt = _jax_partition(name, jnp.float32)
    ep = _edge_params(name, jt)
    je = JTreeEngine(jp, jt, pallas="interpret", edge_params=ep, **kw)
    te = tp.TreeEngine(_port(jp, torch.float32), tt, edge_params=ep, **kw)
    assert je.use_fused and te.use_fused
    count = 3 if name == "protein" else 6
    jc, tc = _batches("nni", jt, tt, count)
    _assert_rel(te.evaluate_topologies(tc), je.evaluate_topologies(jc),
                rtol)


def test_pool_pallas_f32_matches_jax_pool_interpret():
    """'pool-pallas' scores one candidate a dispatch through the pool
    kernel's plain version here; JAX's through its Pallas pool kernel in
    interpret mode."""
    jp, jt, tt = _jax_partition("repeats", jnp.float32)
    je = JTreeEngine(jp, jt, pallas="pool-interpret")
    te = tp.TreeEngine(_port(jp, torch.float32), tt, pallas="pool")
    assert je.use_repeats_pallas and te.execution_path == "pool-pallas"
    jc, tc = _batches("nni", jt, tt, 3)
    _assert_rel(te.evaluate_topologies(tc), je.evaluate_topologies(jc),
                1e-6)


def test_repeats_dense_fused_unfusable_f32_takes_the_pooled_path():
    """JAX tests/test_repeats_m4.py:357: an unfusable candidate sends the
    batch through the pooled path, and every score stays finite."""
    jp, jt, tt = _jax_partition("repeats", jnp.float32)
    je = JTreeEngine(jp, jt, pallas="interpret")
    te = tp.TreeEngine(_port(jp, torch.float32), tt)
    assert te.execution_path == "repeats-dense-fused"
    jc, tc = _batches("unfusable", jt, tt, 3)
    got = te.evaluate_topologies(tc)
    _assert_rel(got, je.evaluate_topologies(jc), 1e-6)
    _assert_rel(got[3], te.loglikelihood(), 1e-6)


@pytest.mark.parametrize("count", [CANDIDATE_CHUNK + 2, 5])
def test_chunks_of_candidates_f64_match_jax(count, monkeypatch):
    """More candidates than a chunk (two launches, the second of 2) and a
    count that is not a power of two; the port pads nothing."""
    jp, jt, tt = _jax_partition("dna", jnp.float64)
    je = JTreeEngine(jp, jt, pallas=False)
    te = tp.TreeEngine(_port(jp, torch.float64), tt)
    jc, tc = _jax_candidates(jt), _port_candidates(tt)
    reps = -(-count // len(tc))
    jc, tc = (jc * reps)[:count], (tc * reps)[:count]
    walked = []
    plain = tfused.fused_traversal_reference

    def spy(codes, pmatrix, table, *args, **kw):
        if table.ndim == 3:
            walked.append(table.shape[0])
        return plain(codes, pmatrix, table, *args, **kw)

    monkeypatch.setattr(tfused, "fused_traversal_reference", spy)
    got = te.evaluate_topologies(tc)
    assert walked == [min(count - i, CANDIDATE_CHUNK)
                      for i in range(0, count, CANDIDATE_CHUNK)]
    assert got.shape == (count,)
    _assert_rel(got, je.evaluate_topologies(jc), 1e-12)


# ------------------------------------------------ the port against itself
SELF_CASES = {
    "fused_f32": ("dna", torch.float32, dict()),
    "fused_f64": ("dna", torch.float64, dict()),
    "per_rate": ("per_rate", torch.float32, dict()),
    "edge_params": ("edge_params", torch.float32, dict()),
    "levels_kernel": ("dna", torch.float32, dict(pallas="levels-kernel")),
    "pool_pallas": ("repeats", torch.float32, dict(pallas="pool")),
    "repeats_dense_fused": ("repeats", torch.float32, dict()),
}


@pytest.mark.parametrize("case", sorted(SELF_CASES))
def test_each_score_is_set_topology_and_loglikelihood(case):
    name, dtype, kw = SELF_CASES[case]
    jp, _, tt = _jax_partition(name, jnp.float64)
    ep = _edge_params(name, tt)
    te = tp.TreeEngine(_port(jp, dtype), tt, edge_params=ep, **kw)
    ref = tp.TreeEngine(_port(jp, dtype), tt, edge_params=ep, **kw)
    scores = te.evaluate_topologies(_port_candidates(tt, 6))
    want = []
    for h, move in tmoves.nni_neighbours(tt)[:6]:
        rb = tmoves.Rollback()
        tmoves.nni(h, move, rb)
        ref.set_topology(tt)
        want.append(ref.loglikelihood())
        tmoves.rollback_move(rb)
    _assert_rel(scores, want, 1e-12 if dtype == torch.float64 else 1e-6)


@pytest.mark.parametrize("name", ["dna", "per_rate", "raw_tips",
                                  "edge_params", "protein"])
def test_evaluate_packed_equals_evaluate_topologies(name):
    """JAX tests/test_search.py:183: pack_candidate + evaluate_packed, and
    the same arrays stacked through evaluate_packed_arrays, score what
    evaluate_topologies scores."""
    jp, _, tt = _jax_partition(name, jnp.float64)
    ep = _edge_params(name, tt)
    te = tp.TreeEngine(_port(jp, torch.float32), tt, edge_params=ep)
    objs, packed = [], []
    for h in _inner_edges(tt)[:5]:
        rb = tmoves.Rollback()
        tmoves.nni(h, C.UTREE_MOVE_NNI_LEFT, rb)
        packed.append(te.pack_candidate(tt.vroot))
        objs.append(_current(tt, ttrees, root_as_node=False))
        tmoves.rollback_move(rb)
    want = te.evaluate_topologies(objs)
    np.testing.assert_array_equal(te.evaluate_packed(packed), want)
    tables, blens, roots, slots = zip(*packed)
    np.testing.assert_array_equal(te.evaluate_packed_arrays(
        np.stack(tables), np.stack(blens), np.asarray(roots), max(slots)),
        want)


def test_candidate_validation():
    jp, _, tt = _jax_partition("dna", jnp.float32)
    te = tp.TreeEngine(_port(jp, torch.float32), tt)
    assert te.evaluate_topologies([]).shape == (0,)
    assert te.evaluate_packed([]).shape == (0,)
    table, blens, root, n_slots = te.pack_candidate(tt.vroot)
    for col, bad in ((3, tt.edge_count), (2, tt.tip_count), (0, n_slots)):
        t = table.copy()[None]
        t[0, 0, col] = bad
        with pytest.raises(tp.PllError, match="out of range"):
            te.evaluate_packed_arrays(t, blens[None], np.asarray([root]),
                                      n_slots)
    with pytest.raises(tp.PllError, match="roots"):
        te.evaluate_packed_arrays(table[None], blens[None, :-1],
                                  np.asarray([root]), n_slots)
    # the tables must have one length, as JAX stacks them
    with pytest.raises(ValueError):
        te.evaluate_packed([(table, blens, root, n_slots),
                            (table[1:], blens, root, n_slots)])


# -------------------------------------------- what scoring leaves alone
LEAVE_CASES = {
    "fused": ("dna", dict(), "nni"),
    "dense_fallback": ("dna", dict(), "unfusable"),
    "pool_pallas": ("repeats", dict(pallas="pool"), "nni"),
    "repeats_fallback": ("repeats", dict(), "unfusable"),
}


@pytest.mark.parametrize("case", sorted(LEAVE_CASES))
def test_scoring_leaves_buffers_and_topology(case):
    """The partition's dense CLV, scaler and P buffers (or pooled buffers
    and layout) and the engine's table, branches, root and logL are as they
    were after scoring."""
    name, kw, kind = LEAVE_CASES[case]
    jp, jt, tt = _jax_partition(name, jnp.float64)
    part = _port(jp, torch.float32)
    te = tp.TreeEngine(part, tt, **kw)
    before = te.loglikelihood()
    if part.repeats is None:
        bufs = (part.clv, part.scale_buffer, part.pmatrix)
    else:
        bufs = (part.clv_flat, part.sc_flat, part.pmatrix)
    snap = [None if b is None else b.clone() for b in bufs]
    layout = getattr(part, "_flat", None)
    eng = (None if te.table is None else te.table.clone(),
           te.branches.clone(), te.root_idx, te.execution_path)
    te.evaluate_topologies(_batches(kind, jt, tt)[1])
    now = ((part.clv, part.scale_buffer, part.pmatrix)
           if part.repeats is None
           else (part.clv_flat, part.sc_flat, part.pmatrix))
    for a, b, c in zip(now, bufs, snap):
        assert a is b and (c is None or torch.equal(a, c))
    assert getattr(part, "_flat", None) is layout
    assert (te.table is None) == (eng[0] is None)
    if te.table is not None:
        assert torch.equal(te.table, eng[0])
    assert torch.equal(te.branches, eng[1])
    assert te.root_idx == eng[2] and te.execution_path == eng[3]
    assert te.loglikelihood() == before
