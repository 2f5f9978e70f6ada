"""Alphabets of 33 to 64 states (ROADMAP A5c-1): 40 states and 61 (the
sense codons) on the port's level and pool routes, against libpll2_tpu.

The tip states are uint64 masks in both packages. The port's fused kernels
stop at 32 states (32-bit tip codes), so `TreeEngine` takes 'levels-kernel'
(dense) and 'pool-pallas' (repeats) by default above that; their kernels'
plain versions run here. JAX's 'fused' path casts the masks to int32 and
returns -inf there (ROADMAP C-J1), and JAX's level and pool kernels in
interpret mode are the float32 reference. Each problem is made from one
seed: a random tree, seeded GTR exchangeabilities and frequencies, an
alignment simulated on the tree with the port's simulator, 6 taxa x 128
sites, two rate categories (JAX's level kernel wants a multiple of 128
sites). Budgets: float64 against JAX's `pallas=False` engine 1e-12 (logL)
and 1e-10 (d1, d2, relative with a floor of 1e-3), float32 against JAX's
kernels in interpret mode TOL_LOGL (bench_validate.py:61-63). Fitch, the
native classer and the stepwise tree at 61 states are held `==`."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libpll2_tpu import Partition as JPartition
from libpll2_tpu import TreeEngine as JTreeEngine
from libpll2_tpu import native as jnative
from libpll2_tpu.optimize import \
    make_fused_loglikelihood_fn as j_make_fused_fn
from libpll2_tpu.parsimony import FastParsimony as JFast
from libpll2_tpu.parsimony.stepwise import fastparsimony_stepwise as j_step
from libpll2_tpu.trees import create_operations as j_create_ops
from libpll2_tpu.trees import export_newick as j_newick
from libpll2_tpu.trees import random_utree as j_random_utree
from libpll2_tpu.trees import traverse as j_traverse
from libpll2_tpu.trees.utree import create_pars_buildops as j_buildops

import libpll2_tpu_torch as tp
from libpll2_tpu_torch import native
from libpll2_tpu_torch.engine import choose_route
from libpll2_tpu_torch.optimize import make_fused_loglikelihood_fn
from libpll2_tpu_torch.parsimony import FastParsimony
from libpll2_tpu_torch.parsimony.stepwise import fastparsimony_stepwise
from libpll2_tpu_torch.trees import (export_newick, random_utree, traverse)
from libpll2_tpu_torch.trees.utree import create_pars_buildops
from libpll2_tpu_torch.utils import simulate_alignment

LETTERS64 = ("ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz"
             "0123456789@#")
TAXA, SITES, RATES = 6, 128, 2
TOL_LOGL = 5e-5


def _charmap(states):
    """State i as LETTERS64[i]; '-' every state."""
    cm = np.zeros(256, np.uint64)
    for i, ch in enumerate(LETTERS64[:states]):
        cm[ord(ch)] = np.uint64(1) << np.uint64(i)
    cm[ord("-")] = np.uint64((1 << states) - 1)
    return cm


def _model(states, seed):
    rng = np.random.default_rng(seed)
    return (rng.dirichlet(np.ones(states) * 5),
            rng.uniform(0.5, 2.0, states * (states - 1) // 2))


def _data(states, seed, scale=1.0, taxa=TAXA, sites=SITES):
    """(labels, {label: sequence}) simulated on `_tree(seed)` (its lengths
    times `scale`) under `_model`, with a few gaps."""
    labels = [f"t{i}" for i in range(taxa)]
    tree = random_utree(labels, seed=seed)
    for h in traverse(tree.vroot):
        if h.back is not None:
            h.length = h.back.length = h.length * scale
    freqs, subst = _model(states, seed)
    headers, seqs = simulate_alignment(tree, sites, freqs, subst, alpha=0.7,
                                       rate_cats=RATES, seed=seed,
                                       alphabet=LETTERS64[:states])
    seqs = [s[:3] + "-" + s[4:] for s in seqs]
    return labels, dict(zip(headers, seqs))


def _partition(jax_side, tree, by, states, seed, dtype, repeats=False,
               rate_scalers=False, rates=RATES):
    n = tree.tip_count
    kw = dict(site_repeats=repeats, rate_scalers=rate_scalers)
    if jax_side:
        part = JPartition(n, n - 2, states, SITES, 1, 2 * n - 3, rates,
                          n - 2, dtype=dtype, **kw)
    else:
        part = tp.Partition(n, n - 2, states, SITES, 1, 2 * n - 3, rates,
                            n - 2, device="cpu", dtype=dtype, **kw)
    for tip in tree.tips():
        part.set_tip_states(tip.clv_index, _charmap(states), by[tip.label])
    freqs, subst = _model(states, seed)
    part.set_frequencies(0, freqs)
    part.set_subst_params(0, subst)
    part.set_category_rates([0.4, 1.6] if rates == 2 else [1.0])
    return part


def _engines(states, seed, jax_pallas, port_pallas, dtype=torch.float64,
             level_schedule=True, **kw):
    """(JAX engine, port engine) on one problem; JAX in float64 unless the
    port runs float32."""
    labels, by = _data(states, seed, scale=0.3 if kw.get("repeats") else 1)
    jt, tt = j_random_utree(labels, seed=seed), random_utree(labels,
                                                             seed=seed)
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    je = JTreeEngine(_partition(True, jt, by, states, seed, jdt, **kw), jt,
                     pallas=jax_pallas)
    te = tp.TreeEngine(_partition(False, tt, by, states, seed, dtype, **kw),
                       tt, pallas=port_pallas, level_schedule=level_schedule)
    return je, te


def _close(got, want, tol, floor=0.0):
    assert abs(got - want) / max(abs(want), floor) < tol, (got, want)


def _hold_to_jax(je, te, steps=2):
    """logL at 1e-12 and `steps` Newton steps' logL, d1 and d2 at 1e-12 /
    1e-10 of JAX's float64 engine."""
    _close(te.loglikelihood(), je.loglikelihood(), 1e-12)
    for _ in range(steps):
        (tl, t1, t2), (jl, j1, j2) = te.newton_step(), je.newton_step()
        _close(tl, jl, 1e-12)
        _close(t1, j1, 1e-10, 1e-3)
        _close(t2, j2, 1e-10, 1e-3)


@pytest.mark.parametrize("states", [33, 40, 61, 64])
def test_partitions_route_off_the_fused_kernels(states):
    """A 33-64-state partition constructs on the CPU in both dtypes; its
    default engine takes 'levels-kernel' (dense) and 'pool-pallas'
    (repeats), as `choose_route` says, and 65 states raise PllError."""
    for dtype in (torch.float32, torch.float64):
        for repeats, path in ((False, "levels-kernel"), (True,
                                                         "pool-pallas")):
            _, te = _engines(states, 3, False, "auto", dtype=dtype,
                             repeats=repeats)
            assert te.partition.states == states
            assert te.execution_path == path
            assert not te.use_fused and not te.repeats_dense_fused
            assert choose_route(states=states, repeats=repeats,
                                dtype=dtype, device_type="cpu").path == path
    with pytest.raises(tp.PllError, match="64-bit"):
        tp.Partition(4, 2, 65, 10, 1, 5, 4, 2, device="cpu")


@pytest.mark.parametrize("path", ["levels-kernel", "levels", "scan"])
@pytest.mark.parametrize("states", [40, 61])
def test_dense_routes_match_jax_float64(states, path):
    """'levels-kernel' (the level kernel's plain version at 64 padded
    states on the card), 'levels' and 'scan' against JAX's `pallas=False`
    float64 engine: logL, Newton steps, d1 and d2."""
    je, te = _engines(states, 5, False, "levels-kernel"
                      if path == "levels-kernel" else False,
                      level_schedule=path != "scan")
    assert te.execution_path == path
    assert je.execution_path == "levels"
    _hold_to_jax(je, te)


def test_per_rate_scalers_at_61_states_match_jax_float64():
    """Per-rate scalers at 61 states on 'levels-kernel' (each rate rescaled
    on its own) and on 'pool-pallas' against JAX's XLA paths in float64."""
    for repeats in (False, True):
        je, te = _engines(61, 6, False, "auto", repeats=repeats,
                          rate_scalers=True)
        assert te.execution_path == ("pool-pallas" if repeats
                                     else "levels-kernel")
        _hold_to_jax(je, te, steps=1)


@pytest.mark.parametrize("path", ["pool-pallas", "pool"])
@pytest.mark.parametrize("states", [40, 61])
def test_repeats_routes_match_jax_float64(states, path):
    """A site-repeats partition on 'pool-pallas' (the pool kernel's plain
    version at 64 padded states on the card) and 'pool' against JAX's
    `pallas=False` float64 engine, which runs its pooled XLA path."""
    je, te = _engines(states, 7, False, "pool" if path == "pool-pallas"
                      else False, repeats=True)
    assert je.execution_path == "pool"
    assert te.execution_path == path
    assert te.partition.repeats is not None
    _hold_to_jax(je, te)


@pytest.mark.parametrize("states", [40, 61])
def test_float32_level_kernel_matches_jax_interpret(states):
    """The port's float32 'levels-kernel' against JAX's level kernel in
    interpret mode (`pallas="levels-interpret"`, one rate category: its
    interpret mode unrolls rates x states), and the float64 value."""
    je, te = _engines(states, 8, "levels-interpret", "levels-kernel",
                      dtype=torch.float32, rates=1)
    assert je.execution_path == "levels-kernel"
    assert te.execution_path == "levels-kernel"
    ref, _ = _engines(states, 8, False, False, rates=1)
    want = ref.loglikelihood()
    _close(je.loglikelihood(), want, TOL_LOGL)
    _close(te.loglikelihood(), want, TOL_LOGL)


@pytest.mark.parametrize("states", [40, 61])
def test_float32_pool_kernel_matches_jax_interpret(states):
    """The port's float32 'pool-pallas' against JAX's pool kernel in
    interpret mode (`pallas="pool-interpret"`, one rate category), and the
    float64 value."""
    je, te = _engines(states, 9, "pool-interpret", "auto",
                      dtype=torch.float32, repeats=True, rates=1)
    assert je.execution_path == "pool-pallas"
    assert te.execution_path == "pool-pallas"
    ref, _ = _engines(states, 9, False, False, repeats=True, rates=1)
    want = ref.loglikelihood()
    _close(je.loglikelihood(), want, TOL_LOGL)
    _close(te.loglikelihood(), want, TOL_LOGL)


def test_jax_fused_kernel_drops_states_from_32_up():
    """At 40 states JAX's 'fused' engine (float32, `pallas="interpret"`)
    returns -inf, as its tip codes keep only bits 0-31 (ROADMAP C-J1); the
    port's default engine leaves the fused kernels and agrees with JAX's
    XLA path."""
    je, te = _engines(40, 10, "interpret", "auto", dtype=torch.float32)
    assert je.execution_path == "fused"
    assert je.loglikelihood() == -np.inf
    assert te.execution_path == "levels-kernel"
    ref, _ = _engines(40, 10, False, False)
    _close(te.loglikelihood(), ref.loglikelihood(), TOL_LOGL)


def test_trials_and_candidates_at_61_states_match_jax_float64():
    """`make_fused_loglikelihood_fn`'s trials on 'levels-kernel' (one call
    of the level kernel's trial form a level on the card) and
    `evaluate_topologies` against JAX's `pallas=False` engine, whose
    candidate scoring and trials run XLA (JAX's fused path, which its
    default would take, returns -inf here)."""
    je, te = _engines(61, 11, False, "auto")
    assert te.execution_path == "levels-kernel"
    groups = ("freqs",)
    jfn, jx0, _ = j_make_fused_fn(je, groups)
    tfn, tx0, _ = make_fused_loglikelihood_fn(te, groups)
    np.testing.assert_allclose(tx0.numpy(), np.asarray(jx0), rtol=1e-12)
    rng = np.random.default_rng(11)
    X = np.asarray(jx0)[None] + rng.normal(0, 0.05, (3, jx0.shape[0]))
    got = tfn(torch.as_tensor(X)).numpy()
    want = np.asarray(jfn(jnp.asarray(X)))
    np.testing.assert_allclose(got, want, rtol=1e-12)
    labels = [f"t{i}" for i in range(TAXA)]
    cands = []
    for seed in (1, 2, 3):
        t = random_utree(labels, seed=seed)
        cands.append(tp.trees.create_operations(traverse(t.vroot))
                     + (t.vroot,))
    jcands = []
    for seed in (1, 2, 3):
        t = j_random_utree(labels, seed=seed)
        jcands.append(j_create_ops(j_traverse(t.vroot)) + (t.vroot,))
    np.testing.assert_allclose(te.evaluate_topologies(cands),
                               je.evaluate_topologies(jcands), rtol=1e-12)


def test_step_by_step_at_61_states_matches_jax_float64():
    """The step-by-step API at 61 states: a full traversal and then a
    partial one through `update_partials` (the level kernel's path), the
    edge logL and its derivatives, against JAX's float64 partition."""
    je, te = _engines(61, 12, False, "auto")
    labels = [f"t{i}" for i in range(TAXA)]
    out = []
    for part, tree, mk in (
            (te.partition, random_utree(labels, seed=12),
             tp.trees.create_operations),
            (je.partition, j_random_utree(labels, seed=12), j_create_ops)):
        trav = traverse(tree.vroot) if part is te.partition \
            else j_traverse(tree.vroot)
        ops, br, pidx = mk(trav)
        part.update_prob_matrices([0] * RATES, pidx, br)
        part.update_partials(ops)
        part.update_partials(ops[len(ops) // 2:])
        r = tree.vroot
        edge = (r.clv_index, r.scaler_index, r.back.clv_index,
                r.back.scaler_index, r.pmatrix_index, [0] * RATES)
        st = part.update_sumtable(*edge[:1], edge[2], edge[1], edge[3],
                                  edge[5])
        out.append((part.compute_edge_loglikelihood(*edge),
                    part.compute_likelihood_derivatives(st, [0] * RATES,
                                                        r.length)))
    (tl, (t1, t2)), (jl, (j1, j2)) = out
    _close(float(tl), float(jl), 1e-12)
    _close(float(t1), float(j1), 1e-10, 1e-3)
    _close(float(t2), float(j2), 1e-10, 1e-3)


def test_fitch_classer_and_stepwise_at_61_states_equal_jax():
    """Fitch (informative sites, packed tips, vectors, node costs, scores),
    the native site-repeats classer on 61-state masks, and the stepwise
    tree's newick and cost `==` JAX's."""
    labels, by = _data(61, 13, taxa=12, sites=200)
    seqs = [by[lab] for lab in labels]
    pair = []
    for jax_side in (True, False):
        cls = JPartition if jax_side else tp.Partition
        kw = {} if jax_side else {"device": "cpu"}
        part = cls(12, 10, 61, 200, 1, 21, 1, 10, **kw)
        for i, s in enumerate(seqs):
            part.set_tip_states(i, _charmap(61), s)
        pair.append((part, (JFast if jax_side else FastParsimony)(part)))
    (jpart, jf), (tpart, tf) = pair
    assert tf.const_cost == jf.const_cost
    np.testing.assert_array_equal(tf.informative, jf.informative)
    np.testing.assert_array_equal(tf.packed_host, jf.packed_host)
    tt, jt = random_utree(labels, seed=13), j_random_utree(labels, seed=13)
    ops = create_pars_buildops(traverse(tt.vroot))
    jops = j_buildops(j_traverse(jt.vroot))
    tf.update_vectors(ops)
    jf.update_vectors(jops)
    np.testing.assert_array_equal(tf.vectors.numpy().view(np.uint32),
                                  np.asarray(jf.vectors)[:-1])
    np.testing.assert_array_equal(tf.node_cost.numpy(),
                                  np.asarray(jf.node_cost)[:-1])
    root = tt.vroot
    assert tf.edge_score(root.node_index, root.back.node_index) == \
        jf.edge_score(root.node_index, root.back.node_index)
    assert native.load() is not None and jnative.load() is not None
    codes = tpart.tip_states[0, :200]
    got, want = native.repeats_tips(codes), jnative.repeats_tips(codes)
    assert got[2] == want[2]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    jtree, jcost = j_step([jf], labels, 5)
    ttree, tcost = fastparsimony_stepwise([tf], labels, 5)
    assert tcost == jcost
    assert export_newick(ttree.vroot) == j_newick(jtree.vroot)


@pytest.mark.parametrize("states", [33, 40, 61, 64])
def test_pool_plan_puts_a_tiles_rates_in_one_cluster(states):
    """ops/_kernels.py:pool_plan from 33 states on: the 64-state body
    (csrc/states64.cuh) runs one rate a block over tiles of
    STATES64_TILE class columns, the rates of a tile in one cluster (at
    most STATES64_MAX_CLUSTER blocks), and runs of tiles from the clusters
    the card keeps resident, over every trial's tiles; 32 states keep
    their rate warps."""
    from libpll2_tpu_torch.ops import _kernels as K

    cols = 40 * K.POOL_GRANULE            # 80 tiles of 64 columns
    # 2 SMs keep one cluster of 4 resident: one run of all 80 tiles
    assert K.pool_plan(cols, 4, states, 2) == K.PoolLaunch(
        1, K.STATES64_TILE, 80, 80, 4, 4)
    # 132 SMs keep 66: runs of 2 tiles, 40 clusters of 4
    assert K.pool_plan(cols, 4, states, 132) == K.PoolLaunch(
        1, K.STATES64_TILE, 80, 2, 160, 4)
    # 3 trials: 240 tiles, runs of 4; and the device's own count
    assert K.pool_plan(cols, 4, states, 132, trials=3) == K.PoolLaunch(
        1, K.STATES64_TILE, 80, 4, 240, 4)
    assert K.pool_plan(cols, 4, states, 132, resident=40).tiles_per_block \
        == 2
    # 10 rates: a cluster of 8, two blocks take 2 rates each
    assert K.pool_plan(K.POOL_GRANULE, 10, states, 2) == K.PoolLaunch(
        1, K.STATES64_TILE, 2, 2, 8, 8)
    assert K.pool_plan(cols, 4, 32, 2).rate_threads == 4
    assert K.pool_plan(cols, 4, 32, 2).cluster == 1
    for bad in (65, 0):
        with pytest.raises(ValueError):
            K.pool_plan(cols, 4, bad, 2)


def test_certified_evaluation_at_61_states_matches_jax_float64():
    """`loglikelihood_df64` above 32 states (the float64 walk's tip codes
    are 32-bit, so it takes the plain float64 level path) on a float32
    partition against JAX's float64 engine. (JAX's own df64 evaluation
    unrolls its state loops and takes minutes to compile at 61 states.)"""
    je, te = _engines(61, 15, False, "auto", dtype=torch.float32)
    assert te.execution_path == "levels-kernel"
    labels = [f"t{i}" for i in range(TAXA)]
    got = tp.loglikelihood_df64(te.partition, random_utree(labels, seed=15))
    ref, _ = _engines(61, 15, False, False)
    _close(got, ref.loglikelihood(), 1e-10)


def test_place_stream_at_61_states_matches_place():
    """Placement at 61 states: `place_stream`'s query codes are 64-bit
    masks above 32 states (a 32-bit code would drop states 32-60), and its
    per-edge logL agrees with `place()`'s full evaluations ('levels-kernel')
    in float64; `place_batch`, off the fused kernels, equals `place()`."""
    from libpll2_tpu_torch.placement import EdgePlacer

    labels, by = _data(61, 16, taxa=TAXA + 1, scale=0.5)
    query = by.pop(labels[-1])
    tree = random_utree(labels[:-1], seed=16)
    freqs, subst = _model(61, 16)
    placer = EdgePlacer(tree, by, states=61, rate_cats=RATES,
                        charmap=_charmap(61), dtype=torch.float64,
                        device="cpu")
    placer.set_model(freqs, subst, rates=[0.4, 1.6])
    codes = placer._query_codes(query)
    assert codes.dtype == np.int64 and int(codes.max()) >= 1 << 32
    single = {r["edge"]: r["logL"] for r in placer.place(query)}
    stream = {r["edge"]: r["logL"]
              for r in placer.place_stream({"q": query})["q"]}
    batch = {r["edge"]: r["logL"]
             for r in placer.place_batch({"q": query})["q"]}
    assert set(single) == set(stream) == set(batch)
    for e, want in single.items():
        _close(stream[e], want, 1e-10)
        _close(batch[e], want, 1e-12)
