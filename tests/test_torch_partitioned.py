"""The port's multi-partition analyses (`libpll2_tpu_torch.PartitionedEngine`)
against libpll2_tpu's on the CPU: tests/test_partitioned.py's cases carried
over, each held against JAX.

JAX builds each problem's partitions; the port's are carried over one by
one with `convert.partition_from_numpy` (float64 on the CPU unless a test
says otherwise), and both packages build the tree from one seed.
Tolerances: float64 logL 1e-12 relative, d1/d2 1e-10 (ROADMAP's parity
budgets), Adam histories and optima 1e-10; rounds accept the same moves
and end at the same logL to 1e-9 (candidate scores differ in summation
order only). JAX's mesh case waits for ROADMAP A8: its place takes the
test that `PartitionedEngine.shard` refuses, naming A8.

A float64 CPU engine of the port runs the fused route (its kernels' plain
versions) where JAX's float64 engine runs XLA (ROADMAP C, a routing
difference): JAX's `maximize` then takes the joint Adam and the port's the
per-partition `maximize_fused`, so a model fit on kernel engines is held
against JAX's `maximize_fused` on each partition (its dense twin), and the
joint Adam cases build both sides with pallas=False."""
import numpy as np
import pytest
import torch

from libpll2_tpu import Partition as JPartition
from libpll2_tpu import TreeEngine as JTreeEngine
from libpll2_tpu import compute_gamma_cats as j_gamma_cats
from libpll2_tpu import optimize as jopt
from libpll2_tpu.io import maps as jmaps
from libpll2_tpu.partitioned import PartitionedEngine as JPartitionedEngine
from libpll2_tpu.search import TreeSearch as JTreeSearch
from libpll2_tpu.search import _internal_edges as j_internal_edges
from libpll2_tpu.trees import random_utree as j_random_utree

import libpll2_tpu_torch as tp
from libpll2_tpu_torch import constants as C
from libpll2_tpu_torch import convert
from libpll2_tpu_torch.optimize import maximize_loglikelihood
from libpll2_tpu_torch.search import TreeSearch, _internal_edges
from libpll2_tpu_torch.trees import moves, random_utree
from libpll2_tpu_torch.utils import simulate_alignment

CPU = "cpu"
F64 = torch.float64
FREQS = [0.3, 0.2, 0.2, 0.3]
SUBST = [1, 2.2, 0.8, 1.1, 2.6, 1]
GTR = [1, 2, 1, 1, 2, 1]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these small problems: the test workers share
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _labels(n):
    return [f"t{i}" for i in range(n)]


def _jax_part(tree, by, sites, freqs=(0.25,) * 4, subst=GTR, alpha=0.9,
              extra_pm=0, extra_sc=0, dtype="float64", repeats=False):
    part = JPartition(tree.tip_count, tree.inner_count, 4, sites, 1,
                      tree.edge_count + extra_pm, 4,
                      tree.inner_count + extra_sc, dtype=dtype,
                      site_repeats=repeats)
    for tip in tree.tips():
        part.set_tip_states(tip.clv_index, jmaps.map_nt, by[tip.label])
    part.set_frequencies(0, list(freqs))
    part.set_subst_params(0, list(subst))
    part.set_category_rates(j_gamma_cats(alpha, 4))
    return part


def _carry(jparts, dtype=F64):
    """The port's partitions: each JAX partition carried over (a repeats
    partition with its classes)."""
    keys = convert.STATE_KEYS + convert.REPEATS_KEYS
    return [convert.partition_from_numpy(
        {k: getattr(jp, k, None) for k in keys}, device=CPU, dtype=dtype)
        for jp in jparts]


def _parts(n_parts=3, seed=61, n=10, **model):
    """tests/test_partitioned.py's `_parts`: `n_parts` alignments of 200 +
    50 k sites simulated on one tree, under `model` (`_jax_part`'s freqs
    and subst). Returns (JAX tree, port tree, JAX partitions, port
    partitions)."""
    jtree = j_random_utree(_labels(n), seed=seed)
    tree = random_utree(_labels(n), seed=seed)
    jparts = []
    for k in range(n_parts):
        headers, seqs = simulate_alignment(tree, 200 + 50 * k, [0.25] * 4,
                                           GTR, alpha=0.9, seed=60 + k)
        jparts.append(_jax_part(jtree, dict(zip(headers, seqs)),
                                200 + 50 * k, **model))
    return jtree, tree, jparts, _carry(jparts)


def _perturb(jtree, tree, seed, moves_n=3):
    """The same seeded NNI moves on both trees."""
    from libpll2_tpu.trees import moves as jmoves
    for t, edges_of, mv in ((jtree, j_internal_edges, jmoves),
                            (tree, _internal_edges, moves)):
        rng = np.random.default_rng(seed)
        for _ in range(moves_n):
            edges = edges_of(t)
            mv.nni(edges[rng.integers(len(edges))],
                   C.UTREE_MOVE_NNI_LEFT, None)


# ------------------------------------- tests/test_partitioned.py, ported
def test_partitioned_logl_is_sum():
    jtree, tree, jparts, parts = _parts()
    pe = tp.PartitionedEngine(parts, tree)
    singles = sum(tp.TreeEngine(p, tree).loglikelihood()
                  for p in _parts()[3])
    np.testing.assert_allclose(pe.loglikelihood(), singles, rtol=1e-12)
    want = JPartitionedEngine(jparts, jtree).loglikelihood()
    np.testing.assert_allclose(pe.loglikelihood(), want, rtol=1e-12)


@pytest.mark.parametrize("linked", [True, False])
def test_partitioned_newton_steps_match_jax(linked):
    """tests/test_partitioned.py's linked Newton case, step by step against
    JAX's (logL 1e-12, d1/d2 1e-10, the root lengths 1e-10), linked and
    unlinked: linked, every engine carries one root length."""
    jtree, tree, jparts, parts = _parts()
    pe = tp.PartitionedEngine(parts, tree, linked=linked)
    jpe = JPartitionedEngine(jparts, jtree, linked=linked)
    lk0 = None
    for _ in range(9):
        got, want = pe.newton_step(), jpe.newton_step()
        np.testing.assert_allclose(got[0], want[0], rtol=1e-12)
        np.testing.assert_allclose(got[1:], want[1:], rtol=1e-10, atol=1e-10)
        lk0 = got[0] if lk0 is None else lk0
    lens = [float(e.branches[int(e.root_idx[4])]) for e in pe.engines]
    jlens = [float(e.branches[int(e.root_idx[4])]) for e in jpe.engines]
    np.testing.assert_allclose(lens, jlens, rtol=1e-10)
    if linked:
        assert got[0] >= lk0 - 1e-9
        assert abs(got[1]) < 1e-2
        assert len(set(lens)) == 1
    else:
        assert len(set(lens)) > 1


@pytest.mark.parametrize("optimize", [("branches",),
                                      ("branches", "subst", "freqs")])
def test_joint_loglikelihood_fn_matches_jax(optimize):
    """`make_joint_loglikelihood_fn`'s keys, value (1e-12) and gradient
    (1e-10) against JAX's, linked branches shared. The model has distinct
    eigenvalues: at repeated ones JAX's eigh derivative is wrong (ROADMAP
    C)."""
    import jax

    jtree, tree, jparts, parts = _parts(n_parts=2, freqs=FREQS,
                                        subst=SUBST)
    pe = tp.PartitionedEngine(parts, tree, pallas=False)
    jpe = JPartitionedEngine(jparts, jtree, pallas=False)
    fn, params = pe.make_joint_loglikelihood_fn(optimize)
    jfn, jparams = jpe.make_joint_loglikelihood_fn(optimize)
    assert sorted(params) == sorted(jparams)
    for k in params:
        np.testing.assert_allclose(params[k].numpy(),
                                   np.asarray(jparams[k]), rtol=1e-12)
    q = {k: v.detach().clone().requires_grad_(True) for k, v in
         params.items()}
    value = fn(q)
    grads = torch.autograd.grad(value, list(q.values()))
    jvalue, jgrads = jax.value_and_grad(jfn)(jparams)
    np.testing.assert_allclose(float(value.detach()), float(jvalue),
                               rtol=1e-12)
    for k, g in zip(q, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jgrads[k]),
                                   rtol=1e-10, atol=1e-10)


def test_partitioned_joint_maximize_matches_concatenated():
    """Joint optimization with linked branches and ONE shared model finds
    the optimum of the concatenated alignment as a single partition (the
    objectives are identical), and equals JAX's joint run."""
    jtree = j_random_utree(_labels(10), seed=71)
    tree = random_utree(_labels(10), seed=71)
    h1, s1 = simulate_alignment(tree, 300, FREQS, SUBST, alpha=0.9,
                                seed=71)
    h2, s2 = simulate_alignment(tree, 200, FREQS, SUBST, alpha=0.9,
                                seed=72)
    by1, by2 = dict(zip(h1, s1)), dict(zip(h2, s2))
    jparts = [_jax_part(jtree, by1, 300, FREQS, SUBST),
              _jax_part(jtree, by2, 200, FREQS, SUBST)]
    pe = tp.PartitionedEngine(_carry(jparts), tree, linked=True,
                              pallas=False)
    jpe = JPartitionedEngine(jparts, jtree, linked=True, pallas=False)
    lk0 = pe.loglikelihood()
    fn, params = pe.make_joint_loglikelihood_fn(("branches",))
    np.testing.assert_allclose(float(fn(params)), lk0, rtol=1e-10)

    final, best, hist = pe.maximize(("branches",), steps=120,
                                    learning_rate=0.05)
    jfinal, _, jhist = jpe.maximize(("branches",), steps=120,
                                    learning_rate=0.05)
    np.testing.assert_allclose(hist, jhist, rtol=1e-10)
    np.testing.assert_allclose(final, jfinal, rtol=1e-10)
    assert final > lk0 + 1.0
    # every engine carries the SAME (linked) optimized branch lengths
    np.testing.assert_allclose(pe.engines[0].branches.numpy(),
                               pe.engines[1].branches.numpy(), rtol=1e-12)
    np.testing.assert_allclose(pe.loglikelihood(), final, rtol=1e-9)

    # the concatenated single-partition optimum
    cat = {k: by1[k] + by2[k] for k in by1}
    eng_c = tp.TreeEngine(_carry([_jax_part(jtree, cat, 500, FREQS,
                                            SUBST)])[0], tree, pallas=False)
    final_c, _, _ = maximize_loglikelihood(eng_c, ("branches",), steps=120,
                                           learning_rate=0.05)
    np.testing.assert_allclose(final, final_c, rtol=1e-6)


def test_partitioned_per_partition_models():
    """Per-partition subst/freqs optimize independently while branches stay
    linked; the joint objective improves, applies back, and equals JAX's
    run."""
    jtree = j_random_utree(_labels(8), seed=81)
    tree = random_utree(_labels(8), seed=81)
    h1, s1 = simulate_alignment(tree, 256, [0.4, 0.1, 0.1, 0.4],
                                [1, 4, 1, 1, 4, 1], alpha=0.9, seed=81)
    h2, s2 = simulate_alignment(tree, 256, [0.1, 0.4, 0.4, 0.1],
                                [2, 1, 2, 2, 1, 2], alpha=0.9, seed=82)
    start = [1, 1.2, 0.9, 1.1, 1.3, 1.0]
    jparts = [_jax_part(jtree, dict(zip(h, s)), 256, subst=start)
              for h, s in ((h1, s1), (h2, s2))]
    pe = tp.PartitionedEngine(_carry(jparts), tree, linked=True,
                              pallas=False)
    jpe = JPartitionedEngine(jparts, jtree, linked=True, pallas=False)
    lk0 = pe.loglikelihood()
    groups = ("branches", "subst", "freqs")
    final, best, hist = pe.maximize(groups, steps=150, learning_rate=0.05)
    jfinal, jbest, jhist = jpe.maximize(groups, steps=150,
                                        learning_rate=0.05)
    assert sorted(best) == sorted(jbest)
    np.testing.assert_allclose(hist, jhist, rtol=1e-10)
    np.testing.assert_allclose(final, jfinal, rtol=1e-10)
    assert final > lk0 + 5.0
    f0 = pe.engines[0].partition.frequencies[0]
    f1 = pe.engines[1].partition.frequencies[0]
    assert f0[0] > f0[1] and f1[1] > f1[0]
    for e, je in zip(pe.engines, jpe.engines):
        np.testing.assert_allclose(e.partition.frequencies,
                                   je.partition.frequencies, rtol=1e-8)
    np.testing.assert_allclose(pe.loglikelihood(), final, rtol=1e-9)


def test_partitioned_topology_search():
    """TreeSearch driven by a PartitionedEngine sums candidate scores across
    partitions and recovers likelihood lost to seeded moves, as JAX's does:
    the same moves, the same logL (1e-9)."""
    jtree, tree, jparts, parts = _parts(n_parts=2, seed=77)
    _perturb(jtree, tree, seed=3)
    pe = tp.PartitionedEngine(parts, tree, linked=True)
    lk0 = pe.loglikelihood()
    search = TreeSearch(None, tree, engine=pe)
    jsearch = JTreeSearch(None, jtree,
                          engine=JPartitionedEngine(jparts, jtree,
                                                    linked=True))
    lk, acc = search.nni_round_batched()
    jlk, jacc = jsearch.nni_round_batched()
    assert acc == jacc and acc >= 1 and lk > lk0 + 0.5
    np.testing.assert_allclose(lk, jlk, rtol=1e-9)
    np.testing.assert_allclose(lk, search.evaluate(), rtol=1e-9)
    np.testing.assert_allclose(
        lk, sum(e.loglikelihood() for e in pe.engines), rtol=1e-9)
    lk2, acc2 = search.spr_round_batched(radius=3)
    jlk2, jacc2 = jsearch.spr_round_batched(radius=3)
    assert acc2 == jacc2 and lk2 >= lk - 1e-6
    np.testing.assert_allclose(lk2, jlk2, rtol=1e-9)


def test_partitioned_shard_names_a8():
    """JAX's mesh case (site sharding, ROADMAP A8, ported): `shard` splits
    every partition's columns over the mesh, and the engine's logL and
    linked Newton step equal the unsharded partitions' and JAX's sharded
    ones (float64)."""
    from libpll2_tpu import parallel as jpar

    from libpll2_tpu_torch.parallel import make_mesh

    jtree, tree, jparts, parts = _parts(n_parts=2)
    ref = tp.PartitionedEngine(_carry(jparts), tree)
    tp.PartitionedEngine.shard(parts, make_mesh(devices=["cpu"] * 2))
    assert all(len(p.shards) == 2 for p in parts)
    pe = tp.PartitionedEngine(parts, tree)
    JPartitionedEngine.shard(jparts, jpar.make_mesh(2))
    je = JPartitionedEngine(jparts, jtree)
    np.testing.assert_allclose(pe.loglikelihood(), ref.loglikelihood(),
                               rtol=1e-12)
    np.testing.assert_allclose(pe.loglikelihood(), je.loglikelihood(),
                               rtol=1e-12)
    got, want = pe.newton_step(), je.newton_step()
    np.testing.assert_allclose(got[0], want[0], rtol=1e-12)
    np.testing.assert_allclose(got[1:], want[1:], rtol=1e-10)


def test_partitioned_maximize_fused_routing():
    """`maximize` on kernel engines routes the model groups to the
    per-partition `maximize_fused` and rejects 'branches' (PllError), as
    JAX's: float32, the keys and the gain of JAX's case, and in float64 the
    histories and optimum against JAX's `maximize_fused` on each dense
    twin (1e-10)."""
    tree = random_utree(_labels(10), seed=61)
    jtree = j_random_utree(_labels(10), seed=61)

    def build(dtype):
        jparts = []
        for k in range(2):
            headers, seqs = simulate_alignment(tree, 300, FREQS, SUBST,
                                               alpha=0.9, seed=70 + k)
            jparts.append(_jax_part(jtree, dict(zip(headers, seqs)), 300,
                                    subst=[1, 1.1, 0.9, 1.05, 0.95, 1]))
        return jparts, _carry(jparts, dtype)

    _, parts = build(torch.float32)
    pe = tp.PartitionedEngine(parts, tree)
    assert all(e.use_fused for e in pe.engines)
    lk0 = pe.loglikelihood()
    with pytest.raises(C.PllError):
        pe.maximize(("branches",))
    lk, params, hist = pe.maximize(("subst", "freqs"), steps=120,
                                   learning_rate=0.05)
    assert lk > lk0 + 1.0
    assert "p0:log_subst" in params and "p1:freq_logits" in params
    assert abs(pe.loglikelihood() - lk) < 5e-2

    jparts, parts = build(F64)
    pe = tp.PartitionedEngine(parts, tree)
    kw = dict(steps=6, chunk=3, patience=10, learning_rate=0.02, tol=1e-6)
    lk, params, hist = pe.maximize(("subst", "freqs"), **kw)
    want = [jopt.maximize_fused(JTreeEngine(jp, jtree, pallas=False),
                                ("subst", "freqs"), **kw) for jp in jparts]
    np.testing.assert_allclose(lk, sum(w[0] for w in want), rtol=1e-10)
    for h, w in zip(hist, want):
        np.testing.assert_allclose(h, w[2], rtol=1e-10)
    for e, jp in zip(pe.engines, jparts):
        np.testing.assert_allclose(e.partition.frequencies, jp.frequencies,
                                   rtol=1e-10)


def test_partitioned_maximize_on_a_pooled_unit():
    """`maximize` with a pooled unit ('pool-pallas' beside a dense plain
    one, both from pallas="pool"): JAX's reaches the NameError of ROADMAP C
    on its pooled engine; the port's follows JAX's dense twins,
    `maximize_fused` on each (1e-10)."""
    jtree, tree, jparts, _ = _parts(n_parts=2, n=8)
    headers, seqs = simulate_alignment(tree, 250, [0.25] * 4, GTR,
                                       alpha=0.9, seed=61)
    jrep = _jax_part(jtree, dict(zip(headers, seqs)), 250, repeats=True)
    parts = _carry([jparts[0], jrep])
    assert parts[1].repeats is not None
    pe = tp.PartitionedEngine(parts, tree, pallas="pool")
    assert [e.execution_path for e in pe.engines] == ["levels",
                                                      "pool-pallas"]
    kw = dict(steps=4, chunk=2, patience=10, learning_rate=0.02, tol=1e-6)
    lk, params, hist = pe.maximize(("freqs",), **kw)
    twins = [jparts[0], _jax_part(jtree, dict(zip(headers, seqs)), 250)]
    want = [jopt.maximize_fused(JTreeEngine(jp, jtree, pallas=False),
                                ("freqs",), **kw) for jp in twins]
    np.testing.assert_allclose(lk, sum(w[0] for w in want), rtol=1e-10)
    for h, w in zip(hist, want):
        np.testing.assert_allclose(h, w[2], rtol=1e-10)
    assert sorted(params) == ["p0:freq_logits", "p1:freq_logits"]
    jpe = JPartitionedEngine([jparts[0], jrep], jtree, pallas="pool")
    assert jpe.engines[1].repeats_mode
    with pytest.raises(NameError, match="_repeats_loglikelihood"):
        jopt.maximize_fused(jpe.engines[1], ("freqs",), **kw)


def _streamed_vs_jax(build, seed, rounds):
    """Each round of `rounds` on the port's streamed search and on JAX's,
    each package on its own copy of the perturbed problem: the same
    accepted moves and logL to 1e-9; the port's streamed rounds equal its
    batched twins too."""
    out = {}
    for kind in ("streamed", "batched"):
        jtree, tree, jparts, parts = build()
        _perturb(jtree, tree, seed=seed)
        linked = rounds["linked"]
        search = TreeSearch(None, tree, engine=tp.PartitionedEngine(
            parts, tree, linked=linked))
        jsearch = JTreeSearch(None, jtree, engine=JPartitionedEngine(
            jparts, jtree, linked=linked))
        if kind == "streamed":
            search.evaluate()
            jsearch.evaluate()
            assert search._streamed_eligible()
        got = []
        for name in rounds["names"]:
            fn = getattr(search, f"{name}_{kind}")
            jfn = getattr(jsearch, f"{name}_{kind}")
            kw = dict(radius=3) if name == "spr_round" else {}
            lk, acc = fn(**kw)
            jlk, jacc = jfn(**kw)
            assert acc == jacc, (kind, name)
            np.testing.assert_allclose(lk, jlk, rtol=1e-9)
            got.append((lk, acc))
        out[kind] = got
    for (a, na), (b, nb) in zip(out["streamed"], out["batched"]):
        assert na == nb
        np.testing.assert_allclose(a, b, rtol=1e-9)


@pytest.mark.parametrize("linked", [True, False])
def test_partitioned_streamed_rounds_match_jax(linked):
    """tests/test_partitioned.py:261-311: streamed NNI and SPR rounds on a
    linked (unlinked: SPR) PartitionedEngine against JAX's and against the
    batched twins."""
    names = ("nni_round", "spr_round") if linked else ("spr_round",)
    _streamed_vs_jax(lambda: _parts(n_parts=2, seed=77), 3,
                     {"linked": linked, "names": names})


def test_partitioned_streamed_mixed_signatures():
    """tests/test_partitioned.py:314-367: partitions with mismatched buffer
    signatures (extra pmatrix slots and scaler rows) stream with one
    schedule per signature, against JAX's rounds and the batched twins."""
    def build():
        jtree = j_random_utree(_labels(10), seed=91)
        tree = random_utree(_labels(10), seed=91)
        jparts = []
        for k, (pm, sc) in enumerate(((0, 0), (3, 2))):
            headers, seqs = simulate_alignment(tree, 128, [0.25] * 4, GTR,
                                               alpha=0.9, seed=80 + k)
            jparts.append(_jax_part(jtree, dict(zip(headers, seqs)), 128,
                                    extra_pm=pm, extra_sc=sc))
        parts = _carry(jparts)
        assert len({TreeSearch._sig(p) for p in parts}) == 2
        return jtree, tree, jparts, parts

    _streamed_vs_jax(build, 5, {"linked": True,
                                "names": ("nni_round", "spr_round")})
