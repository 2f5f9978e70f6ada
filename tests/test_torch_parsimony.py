"""Parsimony in the port (libpll2_tpu_torch.parsimony: Fitch, Sankoff, the
stepwise starting tree; utils/rng.py) against libpll2_tpu on the CPU.

Both packages build the same problem from one seed (an alignment simulated
once, each package's own tree of the same seed and labels). Every result is
integer-valued and held `==`: the glibc shuffle, the informative-site
classification, the packed tips, the Fitch vectors (the port's int32 words
viewed as JAX's uint32) and node costs, edge, root and insertion scores
with and without `chunked`, the Sankoff scores (float32 buffers of integer
costs), ancestral states, and the stepwise tree's newick and cost, native
and through the Python loop. JAX's vectors carry one scratch row (its
padded no-op writes land there) that the port does not have."""
import numpy as np
import pytest
import torch

from libpll2_tpu import Partition as JPartition
from libpll2_tpu import constants as JC
from libpll2_tpu.io import maps as jmaps
from libpll2_tpu.parsimony import FastParsimony as JFast
from libpll2_tpu.parsimony import ParsBuildOp as JBuildOp
from libpll2_tpu.parsimony import Parsimony as JParsimony
from libpll2_tpu.parsimony.stepwise import fastparsimony_stepwise as j_step
from libpll2_tpu.trees import export_newick as j_newick
from libpll2_tpu.trees import parse_newick_rooted as j_rooted
from libpll2_tpu.trees import random_utree as j_random_utree
from libpll2_tpu.trees import rtree as j_rtree
from libpll2_tpu.trees import traverse as j_traverse
from libpll2_tpu.trees.utree import create_pars_buildops as j_buildops
from libpll2_tpu.utils import rng as jrng

import libpll2_tpu_torch as tp
from libpll2_tpu_torch import constants as C
from libpll2_tpu_torch import native
from libpll2_tpu_torch.io import compress_site_patterns, maps
from libpll2_tpu_torch.parsimony import (FastParsimony, ParsBuildOp,
                                         Parsimony, fitch)
from libpll2_tpu_torch.parsimony.stepwise import fastparsimony_stepwise
from libpll2_tpu_torch.trees import (export_newick, parse_newick_rooted,
                                     random_utree, rtree, traverse)
from libpll2_tpu_torch.trees.utree import create_pars_buildops
from libpll2_tpu_torch.utils import rng, simulate_alignment

CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _alignment(n, sites, seed, states=4):
    labels = [f"t{i}" for i in range(n)]
    if states == 4:
        freqs, subst = [0.25] * 4, [1, 2, 1, 1, 2, 1]
    else:
        rng_ = np.random.default_rng(seed)
        freqs = rng_.dirichlet(np.ones(states) * 5)
        subst = rng_.uniform(0.5, 2.0, states * (states - 1) // 2)
    headers, seqs = simulate_alignment(random_utree(labels, seed=seed),
                                       sites, freqs, subst, alpha=1.0,
                                       seed=seed)
    return labels, headers, seqs


def _fitch_pair(headers, seqs, states=4, weights=None):
    """(JAX FastParsimony, port FastParsimony) of the same tips."""
    n, width = len(headers), len(seqs[0])
    out = []
    for jax_side in (True, False):
        if jax_side:
            part = JPartition(n, n - 2, states, width, 1, 2 * n - 3, 1,
                              n - 2)
            cm = jmaps.map_nt if states == 4 else jmaps.map_aa
        else:
            part = tp.Partition(n, n - 2, states, width, 1, 2 * n - 3, 1,
                                n - 2, device=CPU)
            cm = maps.map_nt if states == 4 else maps.map_aa
        for i, s in enumerate(seqs):
            part.set_tip_states(i, cm, s)
        if weights is not None:
            part.set_pattern_weights(weights)
        out.append((JFast if jax_side else FastParsimony)(part))
    return out


def _same_vectors(tf, jf):
    np.testing.assert_array_equal(tf.vectors.numpy().view(np.uint32),
                                  np.asarray(jf.vectors)[:-1])
    np.testing.assert_array_equal(tf.node_cost.numpy(),
                                  np.asarray(jf.node_cost)[:-1])


@pytest.mark.parametrize("seed", [1, 42, 99991, 0xDEADBEEF, 2 ** 31 + 5])
def test_rng_and_shuffle_equal_jax(seed):
    """GlibcRandom's stream and create_shuffled `==` JAX's (after
    tests/test_stepwise_m5.py:32)."""
    a, b = rng.GlibcRandom(seed), jrng.GlibcRandom(seed)
    assert [a.getint(10 ** 6) for _ in range(200)] == \
        [b.getint(10 ** 6) for _ in range(200)]
    for n in (1, 3, 17, 1000):
        assert rng.create_shuffled(n, seed) == jrng.create_shuffled(n, seed)
    assert rng.create_shuffled(6, 0) == list(range(6))


def test_popcount_matches_numpy():
    """The SWAR popcount over int32 words holding uint32 bits, at the
    extremes and on random words."""
    r = np.random.default_rng(3)
    words = np.concatenate([
        np.array([0, 1, 0xFFFFFFFF, 0x80000000, 0x7FFFFFFF, 0x55555555,
                  0xAAAAAAAA], np.uint32),
        r.integers(0, 2 ** 32, 4000, dtype=np.uint64).astype(np.uint32)])
    got = fitch._popcount_sum(torch.from_numpy(
        words.view(np.int32).reshape(-1, 1)))
    want = [bin(int(w)).count("1") for w in words]
    assert got.dtype == torch.int32 and got.tolist() == want


@pytest.mark.parametrize("states,weighted", [(4, False), (4, True),
                                             (20, False)])
def test_fitch_equals_jax(states, weighted):
    """_informative, the packed tips, vectors, node costs, edge_score,
    root_score and batch_insert_scores, chunked and not, `==` JAX's (after
    tests/test_parsimony_m5.py)."""
    labels, headers, seqs = _alignment(16, 300, 21, states)
    weights = None
    if weighted:
        seqs, weights, _ = compress_site_patterns(seqs, maps.map_nt)
    jf, tf = _fitch_pair(headers, seqs, states, weights)
    assert tf.const_cost == jf.const_cost > 0
    assert tf.informative_count == jf.informative_count
    np.testing.assert_array_equal(tf.informative, jf.informative)
    np.testing.assert_array_equal(tf.packed_host, jf.packed_host)

    jt, tt = j_random_utree(labels, seed=21), random_utree(labels, seed=21)
    ops, jops = (create_pars_buildops(traverse(tt.vroot)),
                 j_buildops(j_traverse(jt.vroot)))
    assert [tuple(o) for o in ops] == [tuple(o) for o in jops]
    for chunked in (False, True):
        jf.update_vectors(jops, chunked=chunked)
        tf.update_vectors(ops, chunked=chunked)
        _same_vectors(tf, jf)
    root = tt.vroot
    for a, b in ((root.node_index, root.back.node_index),
                 (ops[0].parent_score_index, ops[0].child1_score_index)):
        assert tf.edge_score(a, b) == jf.edge_score(a, b)
    for o in ops:
        assert tf.root_score(o.parent_score_index) == \
            jf.root_score(o.parent_score_index)
    trav = traverse(tt.vroot)
    e1 = np.array([n.node_index for n in trav if n.back is not None])
    e2 = np.array([n.back.node_index for n in trav if n.back is not None])
    e1, e2 = np.tile(e1, 5), np.tile(e2, 5)          # > one JAX chunk
    for tip in (0, 7):
        for chunked in (False, True):
            got = tf.batch_insert_scores(tip, e1, e2, chunked=chunked)
            want = jf.batch_insert_scores(tip, e1, e2, chunked=chunked)
            assert got.dtype == np.int64
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_fitch_op_lists_with_hazards_equal_jax(seed):
    """Random op lists that overwrite slots other ops read (read after
    write, write after read, write after write): the port's level-by-level
    update `==` JAX's sequential scan, and `op_levels` puts every op after
    what it reads."""
    labels, headers, seqs = _alignment(10, 200, 30 + seed)
    jf, tf = _fitch_pair(headers, seqs)
    r = np.random.default_rng(seed)
    n_slots = tf.vectors.shape[0]
    rows = []
    for _ in range(60):
        p = int(r.integers(tf.tips, n_slots))
        c1, c2 = (int(x) for x in r.integers(0, n_slots, 2))
        rows.append((p, c1, c2))
    levels = fitch.op_levels(rows)
    for k, (p, c1, c2) in enumerate(rows):
        for j in range(k):
            if rows[j][0] in (c1, c2, p):
                assert levels[j] < levels[k]
            if p in rows[j][1:]:
                assert levels[j] <= levels[k]
    jf.update_vectors([JBuildOp(*o) for o in rows])
    tf.update_vectors([ParsBuildOp(*o) for o in rows])
    _same_vectors(tf, jf)


def _sankoff_cost(kind, states):
    if kind == "unit":
        return np.ones((states, states)) - np.eye(states)
    r = np.random.default_rng(states)
    m = r.integers(1, 6, (states, states)).astype(np.float64)
    np.fill_diagonal(m, 0)
    return m


@pytest.mark.parametrize("kind", ["unit", "random"])
def test_sankoff_build_and_score_equal_jax(kind):
    """Sankoff build and per-buffer scores `==` JAX's for integer cost
    matrices over a utree's clv-index traversal (after
    tests/test_parsimony_m5.py:36-74)."""
    labels, headers, seqs = _alignment(16, 300, 21)
    by = dict(zip(headers, seqs))
    cost = _sankoff_cost(kind, 4)
    jt, tt = j_random_utree(labels, seed=21), random_utree(labels, seed=21)
    jp = JParsimony(16, 4, 300, cost, tt.inner_count * 3)
    tpar = Parsimony(16, 4, 300, cost, tt.inner_count * 3, device=CPU)
    assert tpar.sbuffer.dtype == torch.float32
    for jtip, ttip in zip(jt.tips(), tt.tips()):
        jp.set_sequence(jtip.clv_index, jmaps.map_nt, by[jtip.label])
        tpar.set_sequence(ttip.clv_index, maps.map_nt, by[ttip.label])
    trav = traverse(tt.vroot)
    ops = [(n.clv_index, n.next.back.clv_index, n.next.next.back.clv_index)
           for n in trav if not n.is_tip()]
    score = tpar.build([ParsBuildOp(*o) for o in ops])
    assert score == jp.build([JBuildOp(*o) for o in ops]) > 0
    for o in ops:
        assert tpar.score(o[0]) == jp.score(o[0])
    np.testing.assert_array_equal(tpar.sbuffer.numpy(),
                                  np.asarray(jp.sbuffer))
    code = None
    for P, cm, kw in ((JParsimony, jmaps.map_nt, {}),
                      (Parsimony, maps.map_nt, {"device": CPU})):
        with pytest.raises((JC.PllError, C.PllError)) as e:
            P(16, 4, 300, cost, 3, **kw).set_sequence(0, cm, "!" * 300)
        assert code in (None, e.value.errno)
        code = e.value.errno
    assert code == C.ERROR_TIPDATA_ILLEGALSTATE


@pytest.mark.parametrize("kind", ["unit", "random"])
def test_sankoff_reconstruct_equals_jax(kind):
    """Preorder ancestral states on a rooted tree `==` JAX's (after
    tests/test_reconstruct_m5.py)."""
    newick = "(((A:1,B:1):1,(C:1,D:1):1):1,((E:1,F:1):1,G:1):1);"
    r = np.random.default_rng(9)
    seqs = {k: "".join(r.choice(list("ACGTRY-"), 40)) for k in "ABCDEFG"}
    cost = _sankoff_cost(kind, 4)
    out = []
    for parse, mod, P, cm, kw in (
            (j_rooted, j_rtree, JParsimony, jmaps.map_nt, {}),
            (parse_newick_rooted, rtree, Parsimony, maps.map_nt,
             {"device": CPU})):
        tree = parse(newick)
        tips = tree.tip_count
        build = mod.create_pars_buildops(
            mod.traverse(tree.root, order=C.TRAVERSE_POSTORDER))
        rec = mod.create_pars_recops(
            mod.traverse(tree.root, order=C.TRAVERSE_PREORDER))
        pars = P(tips, 4, 40, cost.ravel(), tips - 1,
                 ancestral_buffers=tips - 1, **kw)
        for t in tree.tips():
            pars.set_sequence(t.clv_index, cm, seqs[t.label])
        score = pars.build(build)
        pars.reconstruct(cm, rec)
        out.append((score, [tuple(o) for o in rec],
                    [pars.ancestral(o.node_ancestral_index) for o in rec]))
    assert out[0] == out[1]


def _stepwise_lists(headers, seqs, split):
    """[FastParsimony] pairs of one partition, or of two when `split`."""
    if not split:
        jf, tf = _fitch_pair(headers, seqs)
        return [jf], [tf]
    a = _fitch_pair(headers, [s[:120] for s in seqs])
    b = _fitch_pair(headers, [s[120:] for s in seqs])
    return [a[0], b[0]], [a[1], b[1]]


@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("seed", [1, 42, 99991])
def test_stepwise_equals_jax(seed, split):
    """The stepwise tree's newick and cost `==` JAX's, native and through
    the Python loop (Fitch on the partition's device), one partition and
    two (after tests/test_stepwise_m5.py:82-131)."""
    _, headers, seqs = _alignment(20, 250, 31)
    jl, tl = _stepwise_lists(headers, seqs, split)
    jtree, jcost = j_step(jl, headers, seed)
    assert native.load() is not None
    ntree, ncost = fastparsimony_stepwise(tl, headers, seed)
    ptree, pcost = fastparsimony_stepwise(tl, headers, seed,
                                          use_native=False)
    assert ncost == pcost == jcost
    assert export_newick(ntree.vroot) == export_newick(ptree.vroot) == \
        j_newick(jtree.vroot)
    for t in (ntree, ptree):
        assert sorted(x.label for x in t.tips()) == sorted(headers)
        assert all(x.clv_index == headers.index(x.label) for x in t.tips())


def test_stepwise_without_the_native_library(monkeypatch, capsys):
    """Without the library, the stepwise build and its seed-0 identity
    order take the Python loop and give JAX's tree and cost."""
    _, headers, seqs = _alignment(12, 200, 8)
    jl, tl = _stepwise_lists(headers, seqs, False)
    monkeypatch.setattr(native, "load", lambda: None)
    for seed in (0, 5):
        jtree, jcost = j_step(jl, headers, seed)
        ttree, tcost = fastparsimony_stepwise(tl, headers, seed)
        assert tcost == jcost
        assert export_newick(ttree.vroot) == j_newick(jtree.vroot)


def test_stepwise_refusals_equal_jax():
    """Fewer than three tips, and partitions of other tip counts, raise
    JAX's codes."""
    _, headers, seqs = _alignment(6, 100, 2)
    jl, tl = _stepwise_lists(headers, seqs, False)
    for args, code in (((headers[:2],), C.ERROR_STEPWISE_TIPS),
                       ((headers[:5],), C.ERROR_STEPWISE_STRUCT)):
        with pytest.raises(JC.PllError) as je:
            j_step(jl, *args, 1)
        with pytest.raises(C.PllError) as te:
            fastparsimony_stepwise(tl, *args, 1)
        assert te.value.errno == je.value.errno == code


def test_native_stepwise_checks_its_inputs():
    with pytest.raises(ValueError):
        native.stepwise(np.zeros((4, 8), np.uint32), np.array([4]),
                        np.array([3]), np.arange(4))


def test_native_stepwise_raises_when_the_library_refuses():
    """A build the library refuses (fewer than three tips) raises rather
    than passing for a missing library."""
    if native.load() is None:
        pytest.skip("the native library cannot be built here")
    with pytest.raises(RuntimeError, match="pll_tpu_stepwise failed"):
        native.stepwise(np.zeros((2, 4), np.uint32), np.array([4]),
                        np.array([1]), np.arange(2))
